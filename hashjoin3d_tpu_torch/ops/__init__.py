"""Operators of the port: hashing, carriers, scans, kernels' wrappers,
the chaining table and the windowed probe strand."""
