"""Seconds the program took in set-up to build the cell's TOA tables from
the raw arrivals (host wall, ending in a synchronize)."""


def read(ctx):
    return ctx["setup"]["data_build_s"]
