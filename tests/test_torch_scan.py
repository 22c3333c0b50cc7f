"""K3 ``multi_scan`` as its CUDA kernel decomposes the scan, on the CPU.

``csrc/scan.cu`` runs a single-pass chained scan: tiles of kThreads x kQ x
4 elements, each scanned by 16-byte groups, warps and the block, then
chained to its predecessors by a look-back over their published aggregates
and inclusive prefixes.  :func:`k3_emulate` runs that decomposition with
torch ops, tile constants read from the source, and is held bit-equal to
the JAX package's Pallas kernel in interpret mode at ragged sizes, for
every op, forward and reverse; the wrapper's tile and workspace plan is
unit-tested.  The kernel itself needs the card: ``chip_smoke.py`` holds it
against the plain version there.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashjoin3d_tpu.ops.scan import multi_scan as jax_multi_scan

from hashjoin3d_tpu_torch.ops.scan import (multi_scan, scan_plan,
                                           workspace_words)

I32_MIN, I32_MAX = -2**31, 2**31 - 1


K3_IDENT = {"sum": (0,), "max": (I32_MIN,), "min": (I32_MAX,),
            "maxpair": (I32_MIN, I32_MIN)}


def k3_source_constants():
    """``kThreads`` and ``kQ`` of ``csrc/scan.cu``: a tile is kThreads / 32
    warps x kQ 16-byte groups x 32 lanes x 4 elements."""
    from hashjoin3d_tpu_torch import kernels

    text = (kernels.CSRC / "scan.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", text)
                     .group(1)) for name in ("kThreads", "kQ"))


def _k3_combine(op, a, b):
    """K3's ``combine`` on int64 tensors holding int32 values; ``a`` is the
    earlier operand, each a list of the group's columns."""
    if op == "sum":
        return [(a[0] + b[0] + 2**31) % 2**32 - 2**31]
    if op == "max":
        return [torch.maximum(a[0], b[0])]
    if op == "min":
        return [torch.minimum(a[0], b[0])]
    take_b = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] >= a[1]))
    return [torch.where(take_b, b[0], a[0]), torch.where(take_b, b[1], a[1])]


def _k3_group(op, cols, tiles, seen_prefix):
    """One group of K3, run the way the kernel runs it, on the logical
    columns (identity-padded to whole tiles): thread groups of 4, warp
    scans of the group totals (Hillis-Steele, q after q), warps in order,
    then tile by tile the look-back over 32 predecessors at a time, each
    showing an inclusive prefix where ``seen_prefix[tile][p]`` (else its
    aggregate), reduced by a butterfly; returns the logical outputs."""
    threads, Q = k3_source_constants()
    W = threads // 32
    ident = [torch.tensor(i, dtype=torch.int64) for i in K3_IDENT[op]]

    def comb(a, b):
        return _k3_combine(op, a, b)

    x = [c.view(tiles, W, Q, 32, 4) for c in cols]
    el = [[c[..., j] for c in x] for j in range(4)]
    for j in range(1, 4):
        el[j] = comb(el[j - 1], el[j])
    lane = torch.arange(32)
    t = el[3]
    for d in (1, 2, 4, 8, 16):
        up = comb([torch.roll(c, d, -1) for c in t], t)
        t = [torch.where(lane >= d, u, c) for u, c in zip(up, t)]
    ex = [torch.where(lane >= 1, torch.roll(c, 1, -1), i)
          for c, i in zip(t, ident)]
    carry = [torch.full((tiles, W), int(i)) for i in ident]
    pre = []
    for q in range(Q):
        pre.append(comb([c[..., None] for c in carry],
                        [c[:, :, q] for c in ex]))
        carry = comb(carry, [c[:, :, q, 31] for c in t])
    total = [torch.full((tiles,), int(i)) for i in ident]
    wpre = []
    for w in range(W):
        wpre.append(total)
        total = comb(total, [c[:, w] for c in carry])

    inc, prefix = [], []
    for tt in range(tiles):
        ex_t = [i.clone() for i in ident]
        top = tt - 1
        while tt > 0:
            p = top - lane.numpy()
            shows = np.where(p >= 0, seen_prefix[tt][p.clip(0)], True)
            stop = int(np.argmax(shows)) if shows.any() else 32
            v = [i.repeat(32) for i in ident]
            for ln in range(min(stop + 1, 32)):
                src = inc[p[ln]] if ln == stop else [c[p[ln]] for c in total]
                for c, s in zip(v, src):
                    c[ln] = s
            for m in (16, 8, 4, 2, 1):
                v = comb(v, [c[lane ^ m] for c in v])
            ex_t = comb([c[0] for c in v], ex_t)
            if shows.any():
                break
            top -= 32
        inc.append(comb(ex_t, [c[tt] for c in total]))
        prefix.append(ex_t)

    out = [torch.empty_like(c) for c in x]
    for w in range(W):
        base = comb([torch.stack([pf[i] for pf in prefix])
                     for i in range(len(ident))], [c for c in wpre[w]])
        for q in range(Q):
            pq = comb([c[:, None] for c in base], [c[:, w] for c in pre[q]])
            for j in range(4):
                for o, r in zip(out, comb(pq, [c[:, w, q] for c in el[j]])):
                    o[:, w, q, :, j] = r
    return [o.reshape(-1) for o in out]


def k3_emulate(arrays, ops, reverse, seed=0):
    """K3 in torch, as the kernel decomposes it: tiles of kThreads x kQ x 4
    logical elements; a reverse scan maps logical position l to physical
    ``4 ceil(n / 4) - 1 - l``; logical positions whose physical one is past
    n hold the identity and are not stored.  ``seed`` draws which
    predecessors each tile's look-back finds with an inclusive prefix."""
    threads, Q = k3_source_constants()
    tile = threads * Q * 4
    n = arrays[0].shape[0]
    tiles = -(-n // tile)
    logical = torch.arange(tiles * tile)
    phys = 4 * (-(-n // 4)) - 1 - logical if reverse else logical
    valid = (phys >= 0) & (phys < n)  # past group ceil(n / 4): identity
    phys = phys.clamp(0, n - 1)
    rng = np.random.default_rng(seed)
    seen = [np.concatenate([[True], rng.random(max(tt - 1, 0)) < 0.3])
            for tt in range(tiles)]
    outs, slot = [], 0
    for op in ops:
        k = len(K3_IDENT[op])
        cols = [torch.where(valid, arrays[slot + i].to(torch.int64)[phys],
                            K3_IDENT[op][i]) for i in range(k)]
        for c in _k3_group(op, cols, tiles, seen):
            o = torch.empty(n, dtype=torch.int32)
            o[phys[valid]] = c[valid].to(torch.int32)
            outs.append(o)
        slot += k
    return outs


def _k3_columns(ops, n, seed):
    rng = np.random.default_rng(seed)
    cols = []
    for op in ops:
        if op == "maxpair":  # heavy key ties exercise the payload order
            cols += [rng.integers(-3, 3, n), rng.integers(I32_MIN, I32_MAX, n)]
        else:  # full-range values: sums wrap in int32
            cols.append(rng.integers(I32_MIN, I32_MAX, n))
    cols = [np.asarray(c, np.int32) for c in cols]
    cols[0][:5] = [I32_MIN, I32_MAX, -1, 0, I32_MAX]
    return cols


K3_OPS = [("sum",), ("max",), ("min",), ("maxpair",), ("sum", "max"),
          ("sum", "max", "min", "sum"), ("maxpair", "maxpair"),
          ("min", "maxpair", "max")]


@pytest.mark.parametrize("ops", K3_OPS)
@pytest.mark.parametrize("reverse", [False, True])
def test_k3_decomposition_matches_jax_kernel(ops, reverse):
    """The kernel's decomposition (:func:`k3_emulate`) bit-equal to the
    Pallas kernel in interpret mode at ragged n: 1, one tile - 1, one tile
    + 1 and three tiles + 77 (a forward scan of a prefix of the columns is
    the prefix of their scan, a reverse scan of a suffix the suffix)."""
    threads, Q = k3_source_constants()
    tile = threads * Q * 4
    N = 3 * tile + 77
    cols = _k3_columns(ops, N, 30)
    want = [np.asarray(w) for w in jax_multi_scan(
        tuple(jnp.asarray(c) for c in cols), ops, reverse=reverse, C=tile,
        interpret=True)]
    for n in (1, tile - 1, tile + 1, N):
        part = slice(N - n, N) if reverse else slice(0, n)
        got = k3_emulate([torch.from_numpy(c[part]) for c in cols], ops,
                         reverse, seed=n)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w[part]), (n, ops)


@pytest.mark.parametrize("reverse", [False, True])
def test_k3_lookback_over_several_windows(reverse):
    """40 tiles + 77: look-backs that walk past 32 predecessors before an
    inclusive prefix shows, bit-equal to the plain version."""
    threads, Q = k3_source_constants()
    n = 40 * threads * Q * 4 + 77
    ops = ("sum", "maxpair")
    cols = [torch.from_numpy(c) for c in _k3_columns(ops, n, 31)]
    got = k3_emulate(cols, ops, reverse, seed=3)
    for g, w in zip(got, multi_scan(tuple(cols), ops, reverse=reverse)):
        assert torch.equal(g, w)


def test_k3_scan_plan_and_workspace():
    """Tiles per call, the stream workspace's capacity (a multiple of 4,
    kept while it suffices, at least doubled when it grows) and its words:
    4 header words, then per tile 4 aggregate and 4 prefix words of 64
    bits."""
    threads, Q = k3_source_constants()
    tile = threads * Q * 4
    assert tile == 4096
    assert scan_plan(1, tile) == (1, 4)
    assert scan_plan(tile, tile) == (1, 4)
    assert scan_plan(tile + 1, tile, 4) == (2, 4)
    assert scan_plan(9 * tile, tile, 4) == (9, 12)
    assert scan_plan(5 * tile, tile, 4) == (5, 8)
    assert scan_plan((1 << 24) + 77, tile, 256) == (4097, 4100)
    assert scan_plan(1 << 20, tile, 4100) == (256, 4100)
    assert workspace_words(4) == 68 and workspace_words(256) == 4 + 16 * 256


@pytest.mark.parametrize("helper", ["cumsum_i32", "cummax_i32", "cummin_i32",
                                    "cummax_pair"])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_helpers_match_jax(helper, reverse):
    """The one-call helpers of ``ops/scan.py`` equal the JAX package's
    (``hashjoin3d_tpu/ops/scan.py:365-381``, the Pallas kernel in interpret
    mode over 256-element blocks) at a ragged 3 x 256 + 77 elements."""
    from hashjoin3d_tpu.ops import scan as jax_scan

    from hashjoin3d_tpu_torch.ops import scan

    rng = np.random.default_rng(11 + reverse)
    n = 3 * 256 + 77
    cols = [rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
            for _ in range(2 if helper == "cummax_pair" else 1)]
    cols[0][::7] = cols[0][3]  # ties, for the pair's payload order
    want = getattr(jax_scan, helper)(*(jnp.asarray(c) for c in cols),
                                     reverse=reverse, C=256, interpret=True)
    got = getattr(scan, helper)(*(torch.from_numpy(c) for c in cols),
                                reverse=reverse)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
