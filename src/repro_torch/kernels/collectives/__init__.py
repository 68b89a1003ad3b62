"""Fused collectives on hand-written Hopper kernels.

Port of ``repro.kernels.collectives``: ``ops`` holds the stacked entry
points (the bine, recdoub and ring families and the fused matmul
collectives), ``kernel`` the CUDA kernels' wrappers, ``ref`` their plain
versions.
"""
