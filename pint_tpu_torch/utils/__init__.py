"""Host-side utilities (sexagesimal angles)."""
