"""Fitters: the damped GLS fit of one pulsar."""
