"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels run in interpret mode.

K3 ``multi_scan``, K2 ``windowed_lookup`` (+ ``chunk_bases`` and
``safe_lookup``'s routes), K4 ``bitonic_sort_segmented`` and K1
``bitonic_sort_packed_segmented``.  Inputs are seeded numpy; results must be
exact: scans and lookups bit-equal, sorts with keys bit-equal and each
segment's (key, payload) multiset equal (equal-key payload order is the
network's for the unstable forms).  The CUDA kernels themselves need the
card: ``chip_smoke.py`` holds each against these plain versions there.
"""

import unittest.mock as mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hashjoin3d_tpu.ops import bitonic as JB
from hashjoin3d_tpu.ops.scan import multi_scan as jax_multi_scan
from hashjoin3d_tpu.ops.strands_windowed import _with_route as jax_with_route
from hashjoin3d_tpu.ops.strands_windowed import safe_lookup as jax_safe_lookup
from hashjoin3d_tpu.ops.windowed import chunk_bases as jax_chunk_bases
from hashjoin3d_tpu.ops.windowed import (
    windowed_coverage_ok as jax_coverage_ok)
from hashjoin3d_tpu.ops.windowed import windowed_lookup as jax_windowed_lookup

from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.ops.bitonic import (bitonic_sort_packed_segmented,
                                              bitonic_sort_segmented)
from hashjoin3d_tpu_torch.ops.layout import from_numpy_u32
from hashjoin3d_tpu_torch.ops.scan import multi_scan
from hashjoin3d_tpu_torch.ops.windowed import (chunk_bases, windowed_lookup,
                                               windowed_coverage_ok)

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def t32(a):
    return from_numpy_u32(np.asarray(a), "cpu")


@pytest.mark.parametrize("ops", [("sum",), ("max",), ("min",), ("maxpair",),
                                 ("sum", "max", "min")])
@pytest.mark.parametrize("reverse", [False, True])
def test_multi_scan_plain_matches_jax_kernel(ops, reverse):
    rng = np.random.default_rng(10)
    n = 3 * 256 + 77  # ragged: not a multiple of the kernel block
    cols = []
    for op in ops:
        if op == "maxpair":  # heavy key ties exercise the payload order
            cols += [rng.integers(-3, 3, n), rng.integers(I32_MIN, I32_MAX, n)]
        else:  # full-range values: sums wrap in int32
            cols.append(rng.integers(I32_MIN, I32_MAX, n))
    cols = [np.asarray(c, np.int32) for c in cols]
    cols[0][:5] = [I32_MIN, I32_MAX, -1, 0, I32_MAX]
    want = jax_multi_scan(tuple(jnp.asarray(c) for c in cols), ops,
                          reverse=reverse, C=256, interpret=True)
    got = multi_scan(tuple(torch.from_numpy(c) for c in cols), ops,
                     reverse=reverse)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def _lookup_stream(rng, T, n, C):
    """Sorted keys with -1 miss holes, keys past the table, a chunk mixing
    both table ends (out of window) and keys that are >= 2^31 as u32."""
    keys = np.sort(rng.integers(0, T, n)).astype(np.int32)
    keys[rng.random(n) < 0.1] = -1
    keys[-C // 2:] = T + 5
    keys[30 * C:30 * C + 8] = 0              # far below the chunk's max
    keys[5 * C:6 * C] = I32_MIN + 3           # all-miss chunk, wrapping base
    return keys


def test_windowed_lookup_plain_matches_jax_kernel():
    rng = np.random.default_rng(11)
    T, n, C, W = 8192, 4096, 128, 1024
    table = rng.integers(1, 2**32, T, np.uint64).astype(np.uint32)
    keys = _lookup_stream(rng, T, n, C)
    want = np.asarray(jax_windowed_lookup(jnp.asarray(table),
                                          jnp.asarray(keys), C=C, W=W,
                                          interpret=True))
    got = windowed_lookup(t32(table), torch.from_numpy(keys), C=C, W=W)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert (want[30 * C:30 * C + 8] == 0).all()  # the out-of-window keys
    assert np.array_equal(
        chunk_bases(torch.from_numpy(keys), T, C, W).numpy(),
        np.asarray(jax_chunk_bases(jnp.asarray(keys), T, C, W)))


@pytest.mark.parametrize("case,ok", [("sorted", True), ("ragged", True),
                                     ("sparse", False), ("tail", False)])
def test_windowed_coverage_ok_matches_jax(case, ok):
    rng = np.random.default_rng(15)
    T = 8192
    keys = np.sort(rng.integers(0, T, 16384)).astype(np.int32)
    if case == "ragged":   # length not a multiple of C, holes, past-T keys
        keys = keys[:16000]
        keys[::7] = -1
        keys[-100:] = T + 3
    elif case == "sparse":  # one chunk mixing both table ends
        keys = np.sort(np.array([0, T - 1] * 600, np.int32))
    elif case == "tail":    # a low in-range key under a past-T chunk max
        keys[-1024:] = T + 3
        keys[-1024] = 5
    got = windowed_coverage_ok(torch.from_numpy(keys), T)
    assert got == bool(jax_coverage_ok(jnp.asarray(keys), T)) == ok


def _safe_stream(case, rng, T):
    if case == "windowed":     # spread per chunk << W
        return np.sort(rng.integers(0, T // 4, 8192)).astype(np.int32)
    if case == "patched":      # sorted runs meeting inside 3 chunks
        return np.concatenate([np.sort(rng.integers(-4, T + 4, m))
                               for m in (4000, 4000, 4000, 4384)]
                              ).astype(np.int32)
    return rng.integers(-10, T + 10, 16384).astype(np.int32)  # unsorted


@pytest.mark.parametrize("case,route", [("windowed", 0), ("patched", 1),
                                        ("gather", 2)])
def test_safe_lookup_route_matches_jax(case, route):
    rng = np.random.default_rng(12)
    T, C, W = 5000, 128, 1024
    vals = rng.integers(1, 2**32, T, np.uint64).astype(np.uint32)
    keys = _safe_stream(case, rng, T)
    jax_out = jax_with_route(lambda v, k: {"out": jax_safe_lookup(
        v, k, W=W, C=C)})(jnp.asarray(vals), jnp.asarray(keys))
    out = tw._with_route(lambda v, k: {"out": tw.safe_lookup(
        v, k, W=W, C=C)})(t32(vals), torch.from_numpy(keys))
    want = np.where((keys >= 0) & (keys < T), vals[np.clip(keys, 0, T - 1)],
                    0)
    assert np.array_equal(np.asarray(jax_out["out"]), want)
    assert np.array_equal(out["out"].numpy().view(np.uint32), want)
    assert out["route_worst"] == int(jax_out["route_worst"]) == route
    assert out["route_nbad"] == int(jax_out["route_nbad"])


def _same_segments(got, want, chunk):
    """Keys bit-equal; each segment's (key, payload) multiset equal."""
    gk, gv = (np.asarray(x).view(np.int32).reshape(-1, chunk) for x in got)
    wk, wv = (np.asarray(x).view(np.int32).reshape(-1, chunk) for x in want)
    assert np.array_equal(gk, wk)
    for s in range(gk.shape[0]):
        assert (sorted(zip(gk[s], gv[s])) == sorted(zip(wk[s], wv[s])))


@pytest.mark.parametrize("form", ["1op_signed", "2op_unsigned_stable",
                                  "2op_unsigned_unstable", "2op_signed"])
def test_bitonic_sort_segmented_plain_matches_jax_kernel(form):
    rng = np.random.default_rng(13)
    chunk, P = 1024, 4096
    lid = np.tile(np.arange(chunk, dtype=np.int32), P // chunk)
    if form == "1op_signed":   # bucket ids with -1 dead markers
        keys = rng.integers(0, 300, P).astype(np.int32)
        keys[rng.random(P) < 0.3] = -1
    elif form == "2op_signed":
        keys = rng.integers(-9, 9, P).astype(np.int32)
    else:                      # heavy ties, keys >= 2^31 as u32
        keys = rng.choice(np.array([0, 3, 2**31 - 1, 2**31, 2**32 - 1],
                                   np.uint32), P)
    unsigned = form.startswith("2op_unsigned")
    stable = form != "2op_unsigned_unstable"
    jops = (jnp.asarray(keys),) if form == "1op_signed" else (
        jnp.asarray(keys), jnp.asarray(lid))
    with mock.patch.object(JB, "UNROLL_MAX", 256):  # hybrid passes
        want = JB._bitonic_pallas(jops, chunk, unsigned, True, stable)
    payload = None if form == "1op_signed" else torch.from_numpy(lid)
    got = bitonic_sort_segmented(t32(keys), chunk, payload=payload,
                                 unsigned=unsigned, stable=stable)
    if form == "1op_signed":
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    elif stable:
        assert np.array_equal(got[0].numpy().view(np.uint32) if unsigned
                              else got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        _same_segments(got, want, chunk)


def test_bitonic_sort_packed_plain_matches_jax_kernel():
    rng = np.random.default_rng(14)
    chunk, P, key_bits = 1024, 4096, 24
    keys = rng.integers(0, 1 << key_bits, P).astype(np.uint32)
    keys[:600] = keys[600]  # ties across a segment
    with mock.patch.object(JB, "UNROLL_MAX", 256):
        want = JB.bitonic_sort_packed_segmented(jnp.asarray(keys), chunk,
                                                key_bits, interpret=True)
    got = bitonic_sort_packed_segmented(t32(keys), chunk, key_bits)
    _same_segments(got, want, chunk)
    k2, rows = keys.reshape(-1, chunk), got[1].numpy().reshape(-1, chunk)
    for s in range(P // chunk):  # rows are local and carry their own key
        assert np.array_equal(k2[s][rows[s]],
                              got[0].numpy().view(np.uint32)
                              .reshape(-1, chunk)[s])


@pytest.mark.parametrize("call", [
    lambda x: bitonic_sort_segmented(x, 256),
    lambda x: bitonic_sort_packed_segmented(x, 256, 20),
    lambda x: windowed_lookup(x, x, C=128, W=1024),
    lambda x: multi_scan((x,), ("sum",)),
])
def test_wrappers_launch_or_raise_off_the_cpu(call):
    """Only CPU tensors take the plain version: any other device must reach
    the kernel (CUDA) or raise, never compute on the side."""
    x = torch.empty(2048, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call(x)
