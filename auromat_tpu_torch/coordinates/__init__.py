"""Coordinate-system code: frames, igrf, the WCS header parse (host
float64), geodesics (host numpy) and coordinate transforms (torch)."""
