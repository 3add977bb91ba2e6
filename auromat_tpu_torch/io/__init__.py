"""Host-side file I/O: FITS headers (the subset the port needs) and images."""
