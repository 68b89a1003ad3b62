"""Hand-written Hopper kernels of the port (``repro.kernels``)."""
