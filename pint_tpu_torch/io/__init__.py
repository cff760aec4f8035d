"""File formats (par files)."""
