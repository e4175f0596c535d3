"""Utilities: profiling and timing."""
