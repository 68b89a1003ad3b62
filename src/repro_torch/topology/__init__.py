"""Gradient-bucket capacities of the packaged topology presets.

The port's copy of the ``bucket_bytes`` entries of the five decision
tables packaged with the JAX package (``repro/topology/tables/*.json``),
and the lookup ``select_bucket_bytes`` that ``TrainConfig(bucket_bytes=-1)``
resolves through.  The rest of the decision tables (``backend="auto"``)
is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict

_MiB = 1 << 20

#: preset -> DP rank count -> bucket capacity in wire-dtype bytes
BUCKET_BYTES: Dict[str, Dict[int, int]] = {
    "leonardo": {4: 64 * _MiB, 8: 64 * _MiB, 16: 64 * _MiB, 32: 64 * _MiB,
                 64: 64 * _MiB, 128: 64 * _MiB},
    "lumi": {4: 64 * _MiB, 8: 64 * _MiB, 16: 64 * _MiB, 32: 64 * _MiB,
             64: 64 * _MiB, 128: 64 * _MiB},
    "marenostrum5": {4: 64 * _MiB, 8: 64 * _MiB, 16: 64 * _MiB,
                     32: 64 * _MiB, 64: 64 * _MiB, 128: 64 * _MiB},
    "torus": {4: 32 * _MiB, 8: 64 * _MiB, 16: 64 * _MiB, 32: 64 * _MiB,
              64: 64 * _MiB, 128: 64 * _MiB},
    "tpu_multipod": {4: 64 * _MiB, 8: 64 * _MiB, 16: 64 * _MiB,
                     32: 64 * _MiB, 64: 64 * _MiB, 128: 64 * _MiB},
}


def _nearest_p(ps, p: int) -> int:
    """The table's grid point for ``p``: nearest in log2, ties to the
    larger (the reference's ``DecisionTable.nearest_p``)."""
    if p in ps:
        return p
    lg = math.log2(max(p, 1))
    return min(ps, key=lambda q: (abs(math.log2(q) - lg), -q))


def select_bucket_bytes(p: int, topology: str = "tpu_multipod") -> int:
    """Gradient-bucket capacity in bytes for ``p`` DP ranks."""
    if topology not in BUCKET_BYTES:
        raise ValueError(f"unknown topology {topology!r}; known: "
                         f"{sorted(BUCKET_BYTES)}")
    table = BUCKET_BYTES[topology]
    return table[_nearest_p(sorted(table), p)]
