"""Bundled data tables (leap seconds, the TDB-TT series).

Copies of ``pint_tpu.data``'s tables, shipped as Python modules so they
load with no file IO.
"""
