"""Georeferenced-image data model and the functions that build it."""
