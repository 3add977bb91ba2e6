"""Offline astrometric calibration: star-field masking + astrometry.net.

Host-side CV and subprocess work (reference layer L4), counterpart of
``auromat_tpu.solving``: it produces the ``.wcs`` solutions that the
georeferencing on the card consumes. ``spacecraft.intersects_earth`` and
``is_consistent`` check a solution by georeferencing points on the card.
"""
