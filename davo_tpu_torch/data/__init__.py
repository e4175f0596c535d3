"""Host-side data sources (NumPy/SciPy)."""
