"""Streaming inference and trajectory metrics."""
