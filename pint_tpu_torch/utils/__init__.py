"""Host-side utilities (sexagesimal angles, DMX reports, WaveX setup)."""
