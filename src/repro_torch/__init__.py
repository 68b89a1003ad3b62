"""PyTorch/CUDA port of the Bine-tree collectives stack (``repro``).

Sub-packages mirror ``src/repro/`` so each module has a named
counterpart.  The port imports ``torch``, numpy and the standard library
only — never ``jax`` and nothing of ``repro``.  Its DP ranks run stacked on
one device: every per-rank buffer carries a leading ``[p]`` rank axis.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises instead of falling back when CUDA is asked for and
    missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
