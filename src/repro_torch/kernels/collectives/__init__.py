"""Fused butterfly collectives on hand-written Hopper kernels.

Port of ``repro.kernels.collectives``: ``ops`` holds the stacked entry
points, ``kernel`` the CUDA kernels' wrappers, ``ref`` their plain
versions.
"""
