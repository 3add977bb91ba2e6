"""Host-side file I/O: FITS headers (the subset the fused path needs)."""
