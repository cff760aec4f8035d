"""Adapters from a traffic mix to the program's entry points, found by name."""
