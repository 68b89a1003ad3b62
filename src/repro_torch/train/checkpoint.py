"""Checkpoints: async save, restore-from-latest, the reference's format.

Port of ``repro.train.checkpoint``, on disk byte for byte the same layout,
so a checkpoint written by either package restores in the other:

  step_<N:08d>/
    manifest.json   step, treedef string, n_leaves, shapes, dtypes,
                    leaf paths, extra, time
    arrays.npz      the flat leaves keyed ``a<i>``, in the reference's
                    flatten order (dict keys sorted)

A step is written into ``step_<N>.tmp`` and renamed into place, and
``keep`` bounds how many steps stay.  Leaves are torch tensors (any
device) or numpy arrays.  numpy has no bfloat16 (and the port does not use
``ml_dtypes``), so a bfloat16 leaf is stored as the reference's npz stores
one: its 2-byte patterns as void ``V2``, with ``"bfloat16"`` as its
manifest dtype; reading such a leaf views the bytes as ``torch.bfloat16``.
Both directions are bit for bit.

A train state is saved as its global (logical) arrays
(``train.step.to_global``) and restored through ``train.step.from_global``,
which re-slices the optimizer state at any DP size.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as T

BF16 = "bfloat16"


def _treedef_str(tree) -> str:
    """``str(jax.tree.structure(tree))`` of the same tree:
    ``PyTreeDef({'a': *, 'b': [*, *]})``."""
    def one(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {one(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(one(v) for v in node) + "]"
        return "*"
    return f"PyTreeDef({one(tree)})"


def _host(x) -> np.ndarray:
    """One leaf as the numpy array ``arrays.npz`` holds (bfloat16 as V2)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def save(path: str, step: int, tree: Any, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Synchronous save of a tree of tensors or numpy arrays."""
    d = os.path.join(path, f"step_{step:08d}")
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = T.flatten_with_path(tree)
    leaves = [x for _, x in flat]
    arrays = {f"a{i}": _host(x) for i, x in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "treedef": _treedef_str(tree),
        "n_leaves": len(leaves),
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [_dtype_name(x) for x in leaves],
        # leaf paths label shape mismatches on restore
        "paths": [T.keystr(p) for p, _ in flat],
        "extra": extra or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    _gc(path, keep)
    return d


def _gc(path: str, keep: int):
    steps = sorted(all_steps(path))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)


def all_steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    out = []
    for n in os.listdir(path):
        if n.startswith("step_") and not n.endswith(".tmp"):
            if os.path.exists(os.path.join(path, n, "manifest.json")):
                out.append(int(n[5:]))
    return sorted(out)


def latest_step(path: str) -> Optional[int]:
    s = all_steps(path)
    return s[-1] if s else None


def load_leaf(data, i: int, manifest: Dict) -> torch.Tensor:
    """Leaf ``i`` of ``arrays.npz`` as a CPU tensor of its manifest dtype:
    a void (``V2``) leaf whose manifest dtype is bfloat16 is viewed as
    ``torch.bfloat16``, bit for bit."""
    arr = data[f"a{i}"]
    dtypes = manifest.get("dtypes") or []
    if arr.dtype.kind == "V":
        if i >= len(dtypes) or dtypes[i] != BF16 or arr.dtype.itemsize != 2:
            raise ValueError(f"leaf {i}: raw {arr.dtype} bytes with manifest "
                             f"dtype {dtypes[i] if i < len(dtypes) else None}"
                             f"; only bfloat16 is stored as void")
        return torch.from_numpy(_writable(arr.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(_writable(arr))


def _writable(arr: np.ndarray) -> np.ndarray:
    """``arr`` itself where torch may own it (npz reads fill a fresh
    array), else a copy."""
    return arr if arr.flags.writeable else arr.copy()


def restore(path: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of ``like``: a tree of tensors (any
    device, "meta" included) or numpy arrays, with the logical (global)
    shapes.  Each leaf takes ``like``'s dtype; a tensor leaf lands on
    ``device`` if given, else on ``like``'s device, a numpy leaf stays
    numpy.  A shape mismatch raises ``AssertionError`` naming the leaf's
    path, as the reference's restore does."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = T.flatten_with_path(like)
    assert manifest["n_leaves"] == len(flat_like), (
        f"leaf count mismatch: ckpt {manifest['n_leaves']} vs "
        f"{len(flat_like)}")
    paths = manifest.get("paths") or [T.keystr(p) for p, _ in flat_like]
    flat = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for i, (_, lk) in enumerate(flat_like):
            t = load_leaf(data, i, manifest)
            label = paths[i] if i < len(paths) else f"leaf {i}"
            want = tuple(np.shape(lk)) if not isinstance(
                lk, torch.Tensor) else tuple(lk.shape)
            assert tuple(t.shape) == want, (
                f"{label}: ckpt {tuple(t.shape)} vs expected {want}")
            if isinstance(lk, torch.Tensor):
                flat.append(t.to(device if device is not None
                                 else lk.device, lk.dtype))
            else:
                if t.dtype == torch.bfloat16:
                    raise TypeError(f"{label}: a bfloat16 leaf restores "
                                    "into a tensor, not a numpy array")
                flat.append(t.numpy().astype(np.asarray(lk).dtype))
    return T.unflatten(like, flat)


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; at most one in flight.
    ``save`` copies every leaf to the host before the thread starts, so
    the caller may go on updating its tensors in place.  ``last_write_s``
    is the worker's wall time for the last finished save (the disk side;
    the host copy is the time ``save`` takes to return)."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None
        self.last_write_s: Optional[float] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             block: bool = False):
        self.wait()
        host_tree = T.tree_map(
            lambda x: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.array(x, copy=True), tree)

        def work():
            t0 = time.perf_counter()
            try:
                save(self.path, step, host_tree, extra, self.keep)
            except Exception as e:      # surfaced by the next wait()
                self.last_error = e
            self.last_write_s = time.perf_counter() - t0

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error:
            err, self.last_error = self.last_error, None
            raise err
