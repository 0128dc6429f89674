"""Profiling and environment utilities (the port of ``svtpu/utils``)."""
