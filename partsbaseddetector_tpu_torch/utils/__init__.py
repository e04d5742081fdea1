"""Utilities: detection visualization."""
