"""Numerical core: double-double arithmetic, phases, the Gram kernel."""
