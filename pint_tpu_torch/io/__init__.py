"""File formats (par and tim files)."""
