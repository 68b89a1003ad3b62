"""``launch/profile_flash.bound``, the least time of a flash call that the
profile sets each reading against, counted on the CPU: 4 hd flops for
every (query head, query, key) pair the causal (and window) mask keeps,
summed from the dense mask, over 989 TFLOP/s in bf16 (the tensor cores)
or 67 TFLOP/s in float32 (the CUDA cores), against q, k, v read and o
written once over 3.35 TB/s in 2- or 4-byte elements; the larger bounds
it."""

import pytest
import torch

from repro_torch.launch import profile_flash as PF
from torch_threads import pin_threads  # noqa: F401


def _mask_pairs(T, window):
    pos = torch.arange(T)
    keep = pos[None, :] <= pos[:, None]
    if window is not None:
        keep &= pos[:, None] - pos[None, :] < window
    return int(keep.sum())


#: (B, T, nh, nkv, hd, window): gemma3-4b's causal and windowed inserts,
#: gemma-7b's (bound by bytes), small shapes with a window past T and one
#: of a single key
BOUND_CASES = [
    (1, 2048, 8, 4, 256, None),
    (1, 2048, 8, 4, 256, 1024),
    (1, 1024, 16, 16, 256, None),
    (2, 300, 4, 2, 64, 100),
    (1, 130, 2, 1, 128, 500),
    (1, 64, 2, 2, 80, 1),
]


@pytest.mark.parametrize("case", BOUND_CASES,
                         ids=lambda c: "x".join(map(str, c[:5]))
                         + f"-w{c[5]}")
def test_bound_counts_live_pairs_and_bytes(case):
    Bn, T, nh, nkv, hd, window = case
    t_f = 4 * hd * Bn * nh * _mask_pairs(T, window) / 989e12
    t_b = 2 * Bn * T * (nh + nkv) * hd * 2 / 3.35e12
    ms, by = PF.bound(Bn, T, nh, nkv, hd, window)
    assert ms == pytest.approx(max(t_f, t_b) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_b > t_f else "operations")


def test_bound_of_the_head_dim_256_paths():
    """The bounds quoted for the four head_dim-256 shapes: 0.0174 ms at
    gemma3-4b's causal insert and its serve-TP insert, 0.0130 ms at its
    windowed one (operations), 0.0100 ms at gemma-7b's (bytes)."""
    got = {n: PF.bound(*PF.SHAPES[n]) for n in
           ("hd256", "hd256_tp", "hd256_w", "hd256_g1")}
    assert [round(ms, 4) for ms, _ in got.values()] == \
        [0.0174, 0.0174, 0.0130, 0.0100]
    assert [by for _, by in got.values()] == \
        ["operations", "operations", "operations", "bytes"]


@pytest.mark.parametrize("case", BOUND_CASES,
                         ids=lambda c: "x".join(map(str, c[:5]))
                         + f"-w{c[5]}")
def test_bound_float32_counts_4_byte_elements_at_67_tflops(case):
    Bn, T, nh, nkv, hd, window = case
    t_f = 4 * hd * Bn * nh * _mask_pairs(T, window) / 67e12
    t_b = 2 * Bn * T * (nh + nkv) * hd * 4 / 3.35e12
    ms, by = PF.bound(Bn, T, nh, nkv, hd, window, "float32")
    assert ms == pytest.approx(max(t_f, t_b) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_b > t_f else "operations")


def test_bound_of_the_float32_paths():
    """The float32 bounds quoted for the CUDA-core kernel, all by
    operations: 0.6417 ms at pixtral-12b's frames prefill (q [4, 1024,
    32, 160] over 8), 0.3208 at zamba2-2.7b's shape, 0.2565 at gemma3-4b's
    insert and 0.3850 at musicgen-medium's frames prefill (q [8, 1024, 24,
    64])."""
    got = {n: PF.bound(*PF.SHAPES[n]) for n in
           ("hd160_f32", "hd80_f32", "hd256_f32", "hd64_f32")}
    assert all(PF.SHAPES[n][-1] == "float32" for n in got)
    assert [round(ms, 4) for ms, _ in got.values()] == \
        [0.6417, 0.3208, 0.2565, 0.3850]
    assert {by for _, by in got.values()} == {"operations"}


def test_bound_of_the_bf16_paths():
    """The bf16 bounds quoted for the tensor-core kernel at head_dim 160,
    80 (one rank and over 2 TP ranks) and 128: 0.0435 ms (operations),
    0.0250 twice (bytes), 0.0065 (operations)."""
    got = {n: PF.bound(*PF.SHAPES[n]) for n in
           ("hd160", "hd80", "hd80_tp", "hd128")}
    assert all(PF.SHAPES[n][-1] == "bfloat16" for n in got)
    assert [round(ms, 4) for ms, _ in got.values()] == \
        [0.0435, 0.0250, 0.0250, 0.0065]
    assert [by for _, by in got.values()] == \
        ["operations", "bytes", "bytes", "operations"]
