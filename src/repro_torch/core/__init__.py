"""Graphi core on PyTorch: the graph IR, cost models, policies, simulator,
scheduler, schedule search, capture, profiler and the host runtimes.

Submodules are imported where they are used; this package imports nothing
eagerly.
"""
