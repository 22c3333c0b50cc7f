"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels run in interpret mode.

K3 ``multi_scan``, K2 ``windowed_lookup`` and K2b (``db=True``; +
``chunk_bases`` and ``safe_lookup``'s routes), K4 ``bitonic_sort_segmented``
and K1
``bitonic_sort_packed_segmented``, and the radix sorts' pass plan
(``radix_plan``) run with torch ops.  Inputs are seeded numpy; results must
be exact: scans and lookups bit-equal, sorts with keys bit-equal and each
segment's (key, payload) multiset equal (equal-key payload order is the
network's for the unstable forms).  The CUDA kernels themselves need the
card: ``chip_smoke.py`` holds each against these plain versions there.
"""

import re
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

from hashjoin3d_tpu_torch.ops import chainwalk, probes, runs
from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.ops.bitonic import (bitonic_sort_packed_segmented,
                                              bitonic_sort_segmented,
                                              radix_plan)
from hashjoin3d_tpu_torch.ops.layout import SIGN, from_numpy_u32
from hashjoin3d_tpu_torch.ops.scan import multi_scan
from hashjoin3d_tpu_torch.ops.windowed import (chunk_bases, windowed_lookup,
                                               windowed_coverage_ok,
                                               windowed_lookup_covered)

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


def test_windowed_lookup_db_plain_matches_jax_db_kernel():
    """K2b on the inputs of the JAX package's own db test: bit-equal to the
    Pallas db kernel (interpret mode) and to K2, misses included."""
    rng = np.random.default_rng(7)
    T = 8192
    table = rng.integers(1, 2**32, T, dtype=np.uint32)
    keys = np.sort(rng.integers(0, T, 16384).astype(np.int32))
    keys[rng.random(16384) < 0.2] = -1          # miss holes
    want = np.asarray(jax_windowed_lookup(jnp.asarray(table),
                                          jnp.asarray(keys), C=128, W=1024,
                                          interpret=True, db=True))
    got = windowed_lookup(t32(table), torch.from_numpy(keys), C=128, W=1024,
                          db=True)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    k2 = windowed_lookup(t32(table), torch.from_numpy(keys), C=128, W=1024)
    assert torch.equal(got, k2)
    assert (want[keys == -1] == 0).all()


@pytest.mark.parametrize("W", [1024, 2048, 4096, 8192, 16384, 32768])
def test_windowed_lookup_db_window_limit(W):
    """K2b takes every W that K2 takes (neither stages a window, so shared
    memory sets no limit) and equals K2 and the gather on a covered stream
    with a -1 hole and a key past the table; a W that is not a power of two
    raises for both (W = 65536: ``test_windowed_lookup_w65536``)."""
    rng = np.random.default_rng(19)
    T, C, n = W + 2048, 1024, 4096
    table = t32(rng.integers(1, 2**32, T, np.uint64).astype(np.uint32))
    keys = np.sort(rng.integers(0, T, n)).astype(np.int32)
    keys[[100, 2000]] = -1
    keys[-1] = T + 1
    k = torch.from_numpy(keys)
    assert windowed_coverage_ok(k, T, C, W)
    got = windowed_lookup(table, k, C=C, W=W, db=True)
    assert torch.equal(got, windowed_lookup(table, k, C=C, W=W))
    want = np.where((keys >= 0) & (keys < T),
                    table.numpy()[np.clip(keys, 0, T - 1)], 0)
    assert np.array_equal(got.numpy(), want)
    if W == 32768:
        for db in (False, True):
            with pytest.raises(ValueError, match="W must be"):
                windowed_lookup(table, k, C=C, W=W - 1024, db=db)


EDGE_STREAMS = ["sorted", "holes", "new_segment", "gap", "all_miss_wrap",
                "past_table"]


def _edge_stream(kind, rng, T, n, C):
    """A sorted stream, or one with the edge ``kind`` names: 20% -1 holes;
    a second sorted run from the middle of a chunk on (the base moves
    back); half the keys in the table's bottom quarter and half in its top
    quarter (the base jumps past the window); an all-miss chunk of
    ``I32_MIN + 3`` (``kmax - W`` wraps); a tail of keys >= T."""
    keys = np.sort(rng.integers(0, T, n)).astype(np.int32)
    if kind == "holes":
        keys[rng.random(n) < 0.2] = -1
    elif kind == "new_segment":
        cut = n // 2 + C // 3
        keys[cut:] = np.sort(rng.integers(0, T, n - cut))
    elif kind == "gap":
        keys[:n // 2] = np.sort(rng.integers(0, T // 4, n // 2))
        keys[n // 2:] = np.sort(rng.integers(3 * T // 4, T, n - n // 2))
    elif kind == "all_miss_wrap":
        keys[5 * C:6 * C] = I32_MIN + 3
    elif kind == "past_table":
        tail = 3 * C // 2
        keys[-tail:] = np.sort(rng.integers(T, T + 4 * C, tail))
        keys[-3:] = I32_MAX
    return keys


def _np_lookup_covered(table, keys, Tv, C, W):
    """The windowed lookup and ``safe_lookup``'s chunk test
    (``hashjoin3d_tpu/ops/strands_windowed.py:159-166``) in numpy, on the
    JAX package's ``chunk_bases``: (words, bad flags, bad count)."""
    T = table.shape[0]
    k2 = keys.reshape(-1, C).astype(np.int64)
    bases = np.asarray(jax_chunk_bases(jnp.asarray(keys), T, C, W))
    delta = k2 - bases.astype(np.int64)[:, None]
    in_window = (delta >= 0) & (delta < W + 1024)
    words = np.where(in_window.reshape(-1),
                     table[np.clip(keys, 0, T - 1)], 0).astype(np.uint32)
    in_range = (k2 >= 0) & (k2 < Tv)
    bad = ~(~in_range | in_window).all(axis=1)
    return words, bad.astype(np.int32), int(bad.sum())


@pytest.mark.parametrize("stream", EDGE_STREAMS + ["padded", "unaligned"])
def test_windowed_lookup_covered_matches_jax(stream):
    """K2 with its coverage (plain version) on each edge stream, on a
    padded table (5000 values zero-padded to 5120, Tv = 5000) and on a key
    view at element offset 1: words bit-equal to the Pallas kernel in
    interpret mode, ``bad`` and ``nbad`` equal to safe_lookup's chunk test
    in numpy."""
    rng = np.random.default_rng(26)
    T, n, C, W = 8192, 4096, 128, 1024
    Tv = 5000 if stream == "padded" else T
    if stream == "padded":
        T = 5120
    table = np.zeros(T, np.uint32)
    table[:Tv] = rng.integers(1, 2**32, Tv, np.uint64).astype(np.uint32)
    kind = stream if stream in EDGE_STREAMS else "new_segment"
    keys = _edge_stream(kind, rng, T, n, C)
    want = np.asarray(jax_windowed_lookup(jnp.asarray(table),
                                          jnp.asarray(keys), C=C, W=W,
                                          interpret=True))
    np_words, np_bad, np_nbad = _np_lookup_covered(table, keys, Tv, C, W)
    assert np.array_equal(np_words, want)
    k = torch.from_numpy(np.concatenate([keys[:1], keys]))[1:]
    if stream != "unaligned":
        k = k.clone()
    assert (k.data_ptr() % 16 != 0) == (stream == "unaligned")
    out, bad, nbad = windowed_lookup_covered(t32(table), k, Tv, C=C, W=W)
    assert np.array_equal(out.numpy().view(np.uint32), want)
    assert bad.dtype == nbad.dtype == torch.int32
    assert np.array_equal(bad.numpy(), np_bad)
    assert int(nbad) == np_nbad
    assert (np_nbad > 0) == (kind == "new_segment")
    if stream == "padded":  # keys in [Tv, T) are read (as 0), never bad
        assert ((keys >= Tv) & (keys < T)).any()
        assert (out.numpy()[keys >= Tv] == 0).all()


def test_windowed_lookup_w65536():
    """W = 65536, past the old shared-memory cap: K2, K2b and K2 with its
    coverage against numpy on the JAX ``chunk_bases`` (the Pallas kernel's
    select loop would run 520 rows a chunk), on a 2^17-word table with -1
    holes, keys past the table and one uncovered chunk."""
    rng = np.random.default_rng(27)
    T, n, C, W = 1 << 17, 1 << 14, 1024, 65536
    table = rng.integers(1, 2**32, T, np.uint64).astype(np.uint32)
    keys = np.sort(rng.integers(0, T, n)).astype(np.int32)
    keys[rng.random(n) < 0.1] = -1
    keys[-C // 2:] = T + 5
    keys[12 * C] = 0                      # far below chunk 12's window
    np_words, np_bad, np_nbad = _np_lookup_covered(table, keys, T, C, W)
    assert np_bad[12] == 1 and np_nbad == 1
    k = torch.from_numpy(keys)
    for db in (False, True):
        got = windowed_lookup(t32(table), k, C=C, W=W, db=db)
        assert np.array_equal(got.numpy().view(np.uint32), np_words)
    out, bad, nbad = windowed_lookup_covered(t32(table), k, T, C=C, W=W)
    assert np.array_equal(out.numpy().view(np.uint32), np_words)
    assert np.array_equal(bad.numpy(), np_bad) and int(nbad) == np_nbad


@pytest.mark.parametrize("db", [False, True])
@pytest.mark.parametrize("stream", EDGE_STREAMS)
def test_windowed_lookup_edge_streams_match_jax_kernel(stream, db):
    """K2 and K2b (``db``) against the Pallas kernel of the same ``db`` in
    interpret mode, bit-equal, on each edge stream; each stream shows the
    edge it is for (a base that moves back or jumps, misses as 0)."""
    rng = np.random.default_rng(18)
    T, n, C, W = 8192, 4096, 128, 1024
    table = rng.integers(1, 2**32, T, np.uint64).astype(np.uint32)
    keys = _edge_stream(stream, rng, T, n, C)
    want = np.asarray(jax_windowed_lookup(jnp.asarray(table),
                                          jnp.asarray(keys), C=C, W=W,
                                          interpret=True, db=db))
    got = windowed_lookup(t32(table), torch.from_numpy(keys), C=C, W=W,
                          db=db).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    bases = chunk_bases(torch.from_numpy(keys), T, C, W).numpy()
    in_range = (keys >= 0) & (keys < T)
    assert (got[~in_range] == 0).all()
    if stream == "new_segment":
        assert (np.diff(bases) < 0).any()
    elif stream == "gap":
        assert np.diff(bases).max() > W + 1024
    elif stream == "all_miss_wrap":
        # kmax - W wraps to a large positive base, clamped to the top
        assert (got[5 * C:6 * C] == 0).all()
        assert bases[5] == T - (W + 1024)
    elif stream == "past_table":
        assert not in_range[-C:].any() and in_range[-2 * C:-C].any()
    elif stream == "holes":
        assert (keys == -1).mean() > 0.15
    if stream != "new_segment":  # the others are covered: every key hits
        assert (got[in_range] == table[keys[in_range]]).all()


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


def run_radix_plan(plan, keys, payload):
    """The radix plan with torch ops: per pass, in the plan's order, one
    stable sort of every segment by the pass's digit.  A pass whose digit is
    the same for every key is skipped, as the kernels skip it."""
    cols = [torch.from_numpy(keys.view(np.int32)).to(torch.int64),
            torch.from_numpy(payload).to(torch.int64)]
    K = keys.shape[0] // plan.chunk
    for p in plan.passes:
        u = (cols[p.column] ^ plan.flips[p.column]) & 0xFFFFFFFF
        digit = (u >> p.shift) & ((1 << p.bits) - 1)
        if digit.min() == digit.max():
            continue
        idx = torch.sort(digit.view(K, plan.chunk), dim=1,
                         stable=True).indices
        cols = [torch.gather(c.view(K, plan.chunk), 1, idx).view(-1)
                for c in cols]
    return [c.to(torch.int32).numpy() for c in cols]


@pytest.mark.parametrize("chunk,P", [(256, 4096), (16384, 16384)])
@pytest.mark.parametrize("form", ["1op_signed", "2op_unsigned_stable",
                                  "2op_unsigned_take_min", "2op_signed"])
def test_radix_plan_matches_jax_kernel(form, chunk, P):
    """K4's pass plan, run with torch ops, against the Pallas network in
    interpret mode: bit-equal where the JAX kernel's order is defined
    (1-op, stable 2-op with a shuffled payload that is not monotone), keys
    bit-equal and (key, payload) multisets equal for take_min."""
    rng = np.random.default_rng(16)
    if form == "1op_signed":      # bucket ids with -1 dead markers
        keys = rng.integers(0, 300, P).astype(np.int32)
        keys[rng.random(P) < 0.3] = -1
    elif form == "2op_signed":
        keys = rng.integers(-9, 9, P).astype(np.int32)
    elif form == "2op_unsigned_take_min":  # the miss probe: top byte 0
        keys = rng.integers(0, (1 << 20) + (1 << 18), P).astype(np.uint32)
        keys[:P // 8] = keys[0]
    else:                         # heavy ties, keys >= 2^31 as u32
        keys = rng.choice(np.array([0, 3, 2**31 - 1, 2**31, 2**32 - 1],
                                   np.uint32), P)
    unsigned = form.startswith("2op_unsigned")
    stable = form != "2op_unsigned_take_min"
    lid = np.tile(np.arange(chunk, dtype=np.int32), P // chunk)
    payload = lid if not stable else rng.integers(-40, 40, P).astype(
        np.int32)                 # shuffled, duplicated, signed
    nops = 1 if form == "1op_signed" else 2
    plan = radix_plan(32, chunk, nops, stable, unsigned)
    got = run_radix_plan(plan, keys, payload)
    jops = (jnp.asarray(keys),) if nops == 1 else (
        jnp.asarray(keys), jnp.asarray(payload))
    with mock.patch.object(JB, "UNROLL_MAX", 256):  # hybrid passes
        want = [np.asarray(w).view(np.int32)
                for w in JB._bitonic_pallas(jops, chunk, unsigned, True,
                                            stable)]
    if nops == 1 or stable:
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    else:
        _same_segments(got, want, chunk)
        plain = bitonic_sort_segmented(t32(keys), chunk, torch.from_numpy(
            payload))  # input-order ties of an ascending payload
        assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, plain))


@pytest.mark.parametrize("key_bits,chunk,P", [(8, 256, 4096),
                                              (20, 4096, 8192),
                                              (20, 16384, 16384),
                                              (24, 16384, 16384)])
def test_radix_plan_k1_matches_jax_kernel(key_bits, chunk, P):
    """K1's plan (rows from positions) against the packed Pallas kernel in
    interpret mode: keys bit-equal, (key, row) multisets equal, and rows in
    (key, row) order, bit-equal to the plain version."""
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 1 << key_bits, P).astype(np.uint32)
    keys[:300] = keys[300]  # ties across a segment
    lid = np.tile(np.arange(chunk, dtype=np.int32), P // chunk)
    plan = radix_plan(key_bits, chunk, 2, False)
    got = run_radix_plan(plan, keys, lid)
    sub_bits = min(32 - key_bits, 16, chunk.bit_length() - 1)
    with mock.patch.object(JB, "UNROLL_MAX", max(256, 1 << sub_bits)):
        want = JB.bitonic_sort_packed_segmented(jnp.asarray(keys), chunk,
                                                key_bits, interpret=True)
    _same_segments(got, want, chunk)
    plain = bitonic_sort_packed_segmented(t32(keys), chunk, key_bits)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, plain))


@pytest.mark.parametrize("key_bits,nops,stable,widths", [
    (8, 2, False, [8]), (20, 2, False, [7, 7, 6]), (24, 2, False, [8, 8, 8]),
    (31, 2, False, [8, 8, 8, 7]), (32, 1, True, [8, 8, 8, 8]),
    (32, 2, False, [8, 8, 8, 8]), (32, 2, True, [8] * 8)])
def test_radix_plan_passes(key_bits, nops, stable, widths):
    """Digits per key width, columns and offsets, and the kernel's words;
    the passes do not depend on the segment size."""
    plan = radix_plan(key_bits, 1 << 18, nops, stable)
    assert [p.bits for p in plan.passes] == widths
    cols = [p.column for p in plan.passes]
    assert cols == sorted(cols, reverse=True)        # payload digits first
    assert cols.count(1) == (4 if nops == 2 and stable else 0)
    for c in (0, 1):
        shifts = [p.shift for p in plan.passes if p.column == c]
        bits = [p.bits for p in plan.passes if p.column == c]
        assert shifts == [sum(bits[:i]) for i in range(len(bits))]
    assert sum(p.bits for p in plan.passes if p.column == 0) == key_bits
    assert plan.words() == [len(widths), 0, SIGN, *(
        w for p in plan.passes for w in (p.column, p.shift, p.bits))]
    small = radix_plan(key_bits, 256, nops, stable)
    assert small.one_block and not plan.one_block
    assert small.passes == plan.passes


def test_radix_plan_scratch():
    """Scratch words: none for one-block segments; at the main shape (2^24
    keys, 2^18 segments, 7-bit digits) the ping-pong pair, 128 bins per
    4096-key tile and per segment, and the four OR words -- about 130 MiB
    beside the 128 MiB of output."""
    assert sum(radix_plan(20, 8192, 2, False).scratch_words(1 << 24)
               .values()) == 0
    size = radix_plan(20, 1 << 18, 2, False).scratch_words(1 << 24)
    assert list(size) == ["tmp_keys", "tmp_payload", "counts", "segtot",
                          "ors"]  # the kernel's argument order
    assert size == dict(tmp_keys=1 << 24, tmp_payload=1 << 24,
                        counts=(1 << 12) * 128, segtot=64 * 128, ors=4)
    assert radix_plan(32, 1 << 18, 2, True).scratch_words(1 << 24)[
        "counts"] == (1 << 12) * 256  # eight 8-bit passes, one layout
    assert radix_plan(32, 1 << 14, 1, False).scratch_words(1 << 14) == dict(
        tmp_keys=1 << 14, tmp_payload=0, counts=4 * 256, segtot=256, ors=4)
    for bad in ((0, 1), (33, 1), (20, 3)):
        with pytest.raises(ValueError):
            radix_plan(bad[0], 1 << 18, bad[1], False)


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
    lambda x: windowed_lookup(x, x, C=128, W=1024, db=True),
    lambda x: windowed_lookup_covered(x, x, 2048, C=128, W=1024),
    lambda x: multi_scan((x,), ("sum",)),
    lambda x: probes.roll(x.view(-1, 128), 3),
    lambda x: probes.rotate(x.view(-1, 128), x[:16]),
    lambda x: probes.cumsum(x.view(-1, 128), 1),
    lambda x: probes.onehot_matmul(x.view(-1, 128), x.new_empty((128, 128))),
    lambda x: probes.permute(x, x[:1024]),
    lambda x: probes.masked_store(x.view(-1, 128), 8),
    lambda x: probes.block_copy(x, 1024),
    lambda x: probes.row_copy(x.view(-1, 128), 3),
    lambda x: probes.digit_histogram(x.view(-1, 128)),
    lambda x: chainwalk.miss_chain_sum(x, x.new_empty(x.shape,
                                                      dtype=torch.bool), x, 7),
    lambda x: runs.run_directory(x, x, 16),
    lambda x: runs.run_histogram(x, x.long(), 7),
    lambda x: runs.main_chains(x, x, 7),
    lambda x: chainwalk.bucket_ids(x, 7),
    lambda x: chainwalk.bucket_ids(x, 7, "fib",
                                   x.new_empty(x.shape, dtype=torch.bool)),
])
def test_wrappers_launch_or_raise_off_the_cpu(call):
    """Only CPU tensors take the plain version: any other device must reach
    the kernel (CUDA) or raise, never compute on the side."""
    x = torch.empty(2048, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call(x)


def test_every_kernel_source_is_bound_with_its_arity():
    """``kernels._SIGNATURES`` names each ``csrc/*.cu`` once, and every
    entry point it types is defined there with as many parameters."""
    from hashjoin3d_tpu_torch import kernels

    assert set(kernels._SIGNATURES) == {p.name for p in
                                        kernels.CSRC.glob("*.cu")}
    for src, entries in kernels._SIGNATURES.items():
        text = (kernels.CSRC / src).read_text()
        for name, (argtypes, _) in entries.items():
            m = re.search(rf"^(?:const )?\w+\*? {name}\(([^)]*)\)", text,
                          re.M)
            assert m, f"{name} is not defined in {src}"
            params = [p for p in m.group(1).split(",")
                      if p.strip() not in ("", "void")]
            assert len(params) == len(argtypes), name
