"""Demo CLI."""
