"""Per-layer metric readers, one per metric, found by name."""
