"""Compute ops: image resampling, HOG, filter-bank conv, distance
transform, dynamic program, candidate extraction, the walk kernel."""
