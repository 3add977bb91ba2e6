"""Host-side file I/O: FITS headers (the subset the port needs), images,
CDF (``cdflib``) and NetCDF-4 (``nc4``)."""
