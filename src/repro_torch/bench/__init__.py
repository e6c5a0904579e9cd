"""Benchmarks of the port (``kernels_bench``: the kernels and the ZO round
per engine)."""
