"""Telemetry of the fit path: the flight recorder (:mod:`.recorder`)."""
