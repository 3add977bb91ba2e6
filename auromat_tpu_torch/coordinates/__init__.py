"""Coordinate-system host code (per-frame float64 scalars/3x3 matrices):
frames, igrf, and the WCS header parse."""
