"""Geometry and warping."""
