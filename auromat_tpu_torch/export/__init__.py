"""Mapping exporters: netCDF (CF-1.6) and CDF (ISTP-style)."""
