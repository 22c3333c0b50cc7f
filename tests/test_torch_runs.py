"""The runs of a sorted column in one pass (``ops/runs.py``) on the CPU.

``compact_group_index`` and the nested build's ``_main_chains`` now take
their directory and main chains from ``run_directory`` and
``run_histogram``; on CPU tensors those run their plain versions.  Both are
held here, field for field, to the code they replaced, kept here as the
oracle: ``run_boundaries`` (two scans), a head scatter into a ``cap + n``
buffer and three windowed fetches for the directory; ``run_boundaries``,
``sorted_histogram``, an ``arange`` minus the run starts and an inverse
permutation for the main chains.  ``main_chains`` (kernel MC), which now
gives ``_main_chains`` its output with no sort on the card, is held to the
int64 (bucket, first row) sort and the old histogram on synthetic
directories: buckets of exactly ``SHORT_CHAIN`` groups and one more, one
bucket for every group, no live or no dead group, the dead group of a
dropped pad key; and ``_main_chains``' device path, its kernel faked, is
held to one MC launch with no sort.  The wrappers' argument checks are
pinned too.  The CUDA kernels themselves need the card: ``chip_smoke.py``
holds them against the plain versions there.
"""

import numpy as np
import pytest
import torch

from hashjoin3d_tpu_torch import kernels
from hashjoin3d_tpu_torch.ops import runs
from hashjoin3d_tpu_torch.ops import strands_windowed as sw
from hashjoin3d_tpu_torch.ops.hashing import bucket_of, hash_key
from hashjoin3d_tpu_torch.ops.layout import (
    I32, I64, UKEY_PAD, GroupIndex, compact_group_index, i64_to_u32,
    inverse_permute, key_order, run_boundaries, sort_with_rows,
    sorted_histogram, u32_to_i64)
from hashjoin3d_tpu_torch.ops import nested
from hashjoin3d_tpu_torch.ops.nested import _main_chains
from hashjoin3d_tpu_torch.ops.runs import (main_chains, run_directory,
                                           run_histogram)
from hashjoin3d_tpu_torch.utils import tracing

NB = 1000  # main-chain buckets
SHORT_CHAIN = 64  # MC's longest bucket ranked by counting (kShortChain)


def old_compact_group_index(skey, srow, cap, n_valid=None,
                            with_gid_by_row=False, row_values=None):
    """The compacted directory before the one-pass kernel."""
    n = skey.shape[0]
    i = torch.arange(n, dtype=I32)
    is_first, gid, _, run_len = run_boundaries(
        skey, n if n_valid is None else n_valid)
    if n == 0:
        ukey = torch.full((cap,), UKEY_PAD, dtype=skey.dtype)
        group_start = torch.zeros(cap, dtype=I32)
        group_len = torch.zeros(cap, dtype=I32)
        first_row = torch.zeros(cap, dtype=I32)
        n_keys = torch.zeros((), dtype=I32)
    else:
        n_keys = torch.clamp(gid[-1] + 1, min=0)
        slot = torch.arange(cap, dtype=I32)
        pad = slot >= torch.clamp(n_keys, max=cap)
        tgt = torch.where(is_first & (gid < cap), gid, cap + i)
        head = torch.full((cap + n,), n, dtype=I32)
        head[tgt.long()] = i
        head = head[:cap]
        hp = torch.clamp(head, max=n - 1)
        stride = n / cap
        if stride <= 8:
            W, C = sw.stride_params(stride, margin=2.0)

            def fetch(vals):
                return sw.safe_lookup(vals, hp, W=W, C=C)
        else:
            def fetch(vals):
                return vals[hp.long()]
        if skey.dtype == I64:
            hi = fetch(i64_to_u32(skey >> 32))
            lo = fetch(i64_to_u32(skey))
            skey_hp = (hi.to(I64) << 32) | u32_to_i64(lo)
        else:
            skey_hp = fetch(skey)
        ukey = torch.where(pad, UKEY_PAD, skey_hp)
        group_start = torch.where(pad, n, head)
        group_len = torch.where(pad, 0, fetch(run_len))
        first_row = torch.where(pad, n, fetch(srow))
    gid_by_row = torch.zeros(0, dtype=I32)
    if with_gid_by_row:
        live_gid = gid if n_valid is None else torch.where(i < n_valid, gid,
                                                           -1)
        gid_by_row = inverse_permute(srow, live_gid)
    return GroupIndex(ukey=ukey, group_start=group_start,
                      group_len=group_len,
                      group_rows=srow if row_values is None
                      else row_values.to(I32),
                      first_row=first_row, gid_by_row=gid_by_row,
                      n_keys=n_keys.to(I32))


def old_main_chains(groups, num_buckets):
    """The nested build's main chains before the one-pass kernel."""
    cap = groups.ukey.shape[0]
    validg = groups.group_len > 0
    b_main = torch.where(validg, bucket_of(hash_key(groups.ukey, "murmur"),
                                           num_buckets), num_buckets)
    packed = (b_main.to(I64) << 32) | groups.first_row.to(I64)
    pk_s, gid_s = torch.sort(packed, stable=True)
    bm_s = (pk_s >> 32).to(I32)
    is_first_m, _, run_start, run_len_m = run_boundaries(
        bm_s, validg.sum(dtype=I32))
    _, bucket_main_len = sorted_histogram(bm_s, num_buckets, is_first_m,
                                          run_len_m)
    pos_s = torch.arange(cap, dtype=I32) - run_start
    return inverse_permute(gid_s.to(I32), pos_s), bucket_main_len


def old_histogram(values, perm, num_buckets):
    """``run_histogram``'s two outputs the old way: the live prefix are the
    values below ``num_buckets``."""
    n_valid = ((values >= 0) & (values < num_buckets)).sum(dtype=I32)
    is_first, _, run_start, run_len = run_boundaries(values, n_valid)
    _, blen = sorted_histogram(values, num_buckets, is_first, run_len)
    rank = inverse_permute(perm.to(I32),
                           torch.arange(values.shape[0], dtype=I32)
                           - run_start)
    return blen, rank


def column(kind: str, n: int, seed: int, wide: bool = False):
    """A seeded key column on its carrier."""
    rng = np.random.default_rng(seed)
    if kind == "one run":
        k = np.full(n, 0xFFFFFFF0, np.uint64)
    elif kind == "distinct":
        k = rng.permutation(n).astype(np.uint64) * 7 + 2**31
    else:  # duplicates: 1-9 rows a key
        k = rng.integers(0, max(1, n // 4), n).astype(np.uint64) * 3
    if wide:
        k = k * np.uint64(0x9E3779B97F4A7C15)
        k[: min(n, 2)] = [2**64 - 2, 2**63][: min(n, 2)]
        return torch.from_numpy(k.astype(np.uint64).view(np.int64))
    return torch.from_numpy(k.astype(np.uint32).view(np.int32))


def directory_case(kind, n, cap=None, n_valid=None, wide=False,
                   row_values=False, with_gid=False, seed=5):
    """(field, got, want) of the directory and the main chains on one
    column: the new ``compact_group_index`` and ``_main_chains`` against
    the old code on the same phase-1 sort."""
    keys = column(kind, n, seed, wide)
    if n_valid is None:
        skey, srow, nk = sort_with_rows(keys)
        nv = None
    elif n_valid == "inside a run":  # the cut splits a run in two
        skey, srow, _ = sort_with_rows(keys)
        nv = int(np.flatnonzero((skey[1:] == skey[:-1]).numpy())[n // 8]) + 1
        nk = torch.unique(skey[:nv]).numel()
    else:  # the clarity builds' order: the live rows first
        valid = torch.from_numpy(
            np.random.default_rng(seed + 1).random(n) < 0.7)
        order = key_order(keys, valid)
        skey, srow = keys[order], order.to(I32)
        nk = torch.unique(keys[valid]).numel()
        count = valid.sum()
        nv = count if n_valid == "tensor" else int(count)
    if cap is None:
        cap = max(1, int(nk))
    rows = (torch.from_numpy(np.random.default_rng(seed + 2).permutation(n)
                             .astype(np.int32)) if row_values else None)
    got = compact_group_index(keys, skey, srow, cap, nv, with_gid, rows)
    want = old_compact_group_index(skey, srow, cap, nv, with_gid, rows)
    out = [(f, getattr(got, f), getattr(want, f))
           for f in ("ukey", "group_start", "group_len", "group_rows",
                     "first_row", "gid_by_row", "n_keys")]
    mp, bml = _main_chains(got, NB, "murmur")
    old_mp, old_bml = old_main_chains(want, NB)
    return out + [("main_pos_by_group", mp, old_mp),
                  ("bucket_main_len", bml, old_bml)]


def histogram_case(seed=9):
    """(field, got, want) of ``run_histogram`` on sorted bucket ids whose
    tail lies at or past the bucket count (``num_buckets`` itself, larger
    values, and values of 2^31 and more)."""
    rng = np.random.default_rng(seed)
    n, nb = 5000, 700
    v = np.sort(rng.integers(0, nb, n - 60)).astype(np.int64)
    tail = np.array([nb] * 20 + [nb + 3] * 20 + [2**31 + 1] * 10
                    + [2**32 - 1] * 10, np.int64)
    values = torch.from_numpy(np.concatenate([v, tail]).astype(np.uint32)
                              .view(np.int32))
    perm = torch.from_numpy(rng.permutation(n))
    want = old_histogram(values, perm, nb)
    got = run_histogram(values, perm, nb)
    return [("bucket_len", got[0], want[0]), ("rank", got[1], want[1])]


def main_chain_case(sizes, pairs=300, n_dead=0, pad_group=False, nb=1000,
                    seed=13):
    """(field, got, want) of ``main_chains`` against the sort it replaced
    on a synthetic directory: live groups in buckets of ``sizes`` groups
    (bucket i + 3) and two groups in each of ``pairs`` more buckets,
    shuffled, with distinct first rows; then ``n_dead`` dead groups (bucket
    ``nb``, first row n), the first of them a dropped pad key's group with
    a live first row where ``pad_group``."""
    rng = np.random.default_rng(seed)
    spread = rng.choice(np.arange(len(sizes) + 3, nb), pairs, replace=False)
    live_b = rng.permutation(np.concatenate(
        [np.full(m, i + 3) for i, m in enumerate(sizes)]
        + [np.repeat(spread, 2)]))
    n_live = live_b.size
    n = 2 * (n_live + n_dead) + 5
    rows = rng.permutation(n)
    first = np.concatenate([rows[:n_live], np.full(n_dead, n)])
    if pad_group and n_dead:
        first[n_live] = rows[n_live]
    b = torch.from_numpy(np.concatenate([live_b, np.full(n_dead, nb)])
                         .astype(np.int32))
    first = torch.from_numpy(first.astype(np.int32))
    pk_s, gid_s = torch.sort((b.to(I64) << 32) | first.to(I64), stable=True)
    want_len, want_pos = old_histogram((pk_s >> 32).to(I32), gid_s, nb)
    pos, blen = main_chains(b, first, nb)
    return [("main_pos_by_group", pos, want_pos),
            ("bucket_main_len", blen, want_len)]


CASES = {
    "n = 0": lambda: directory_case("duplicates", 0, cap=4),
    "one run": lambda: directory_case("one run", 3000),
    "all distinct": lambda: directory_case("distinct", 4096),
    "duplicates": lambda: directory_case("duplicates", 1 << 14),
    "cap below n_keys": lambda: directory_case("duplicates", 3000, cap=256),
    "cap above n_keys": lambda: directory_case("duplicates", 3000, cap=2048),
    "n_valid < n, an int": lambda: directory_case("duplicates", 3000,
                                                  n_valid="int"),
    "n_valid inside a run": lambda: directory_case(
        "duplicates", 3000, n_valid="inside a run", with_gid=True),
    "n_valid < n, a device scalar": lambda: directory_case(
        "duplicates", 3000, n_valid="tensor", with_gid=True),
    "int64 keys": lambda: directory_case("duplicates", 3000, wide=True),
    "int64 distinct, truncated": lambda: directory_case(
        "distinct", 3000, cap=1024, wide=True),
    "row_values": lambda: directory_case("duplicates", 3000,
                                         row_values=True),
    "with_gid_by_row": lambda: directory_case("duplicates", 3000,
                                              with_gid=True),
    "bucket values >= num_buckets": histogram_case,
    "main chains, short and long buckets": lambda: main_chain_case(
        (SHORT_CHAIN, SHORT_CHAIN + 1, 3 * SHORT_CHAIN, 1500), n_dead=200),
    "main chains, one bucket": lambda: main_chain_case((2000,), pairs=0,
                                                       n_dead=7, nb=5),
    "main chains, a dropped pad key": lambda: main_chain_case(
        (9, 4), n_dead=100, pad_group=True),
    "main chains, no dead group": lambda: main_chain_case((70, 3)),
    "main chains, no live group": lambda: main_chain_case(
        (), pairs=0, n_dead=50, pad_group=True),
    "main chains, no group": lambda: main_chain_case((), pairs=0),
}


@pytest.mark.parametrize("case", CASES)
def test_runs_equal_the_build_code_they_replaced(case):
    for field, got, want in CASES[case]():
        assert got.dtype == want.dtype, field
        assert torch.equal(got, want), field


def test_key_group_index_goes_through_the_directory():
    """The clarity builds' directory at ``cap = n`` with a dead row set:
    groups of the live rows only, -1 for the dead rows' group."""
    from hashjoin3d_tpu_torch.ops.layout import key_group_index

    keys = torch.tensor([5, 3, 5, 9, 3, 3, 7], dtype=I32)
    valid = torch.tensor([1, 1, 1, 0, 1, 0, 1], dtype=torch.bool)
    g = key_group_index(keys, valid)
    assert g.ukey.tolist() == [3, 5, 7, UKEY_PAD, UKEY_PAD, UKEY_PAD,
                               UKEY_PAD]
    assert g.group_len.tolist() == [2, 2, 1, 0, 0, 0, 0]
    assert g.group_start.tolist() == [0, 2, 4, 7, 7, 7, 7]
    assert g.first_row.tolist() == [1, 0, 6, 7, 7, 7, 7]
    assert g.gid_by_row.tolist() == [1, 0, 1, -1, 0, -1, 2]
    assert int(g.n_keys) == 3


x32 = torch.zeros(64, dtype=I32)
x64 = x32.long()


@pytest.mark.parametrize("call, match", [
    (lambda: run_directory(x32.float(), x32, 8), "skey must be a 1-D"),
    (lambda: run_directory(x32.view(8, 8), x32, 8), "skey must be a 1-D"),
    (lambda: run_directory(x32, x32.long(), 8), "srow must be a 1-D int32"),
    (lambda: run_directory(x32, x32[:63], 8), "srow must be shaped"),
    (lambda: run_directory(x32, x32, -1), r"cap -1 must be an int"),
    (lambda: run_directory(x32, x32, 1 << 31), "cap 2147483648 must"),
    (lambda: run_directory(x32, x32, 8.0), "cap 8.0 must be an int"),
    (lambda: run_directory(x32, x32, 8, n_valid=x32[:2]),
     "n_valid must be an int or a one-element"),
    (lambda: run_directory(x32, x32, 8, n_valid=x32[:1].float()),
     "n_valid must be an int or a one-element"),
    (lambda: run_histogram(x32.long(), x64, 8), "values must be a 1-D int32"),
    (lambda: run_histogram(x32, x32, 8), "perm must be a 1-D int64"),
    (lambda: run_histogram(x32, x64[:10], 8), "perm must be shaped"),
    (lambda: run_histogram(x32, x64, 0), "num_buckets 0 must"),
    (lambda: run_histogram(x32, x64, 1 << 31), "num_buckets 2147483648"),
    (lambda: main_chains(x64, x32, 8), "bucket must be a 1-D int32"),
    (lambda: main_chains(x32, x64, 8), "first_row must be a 1-D int32"),
    (lambda: main_chains(x32, x32[:10], 8), "first_row must be shaped"),
    (lambda: main_chains(x32, x32, 0), "num_buckets 0 must"),
])
def test_run_wrappers_refuse_what_the_kernel_does_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_run_wrappers_take_numpy_integers_and_report_every_run():
    """``cap`` may be any integer type; ``n_keys`` counts the runs past
    ``cap`` too."""
    keys = torch.tensor([1, 1, 2, 3, 3, 3, 4], dtype=I32)
    rows = torch.arange(7, dtype=I32)
    ukey, start, length, first, n_keys, gid = run_directory(
        keys, rows, np.int64(2))
    assert ukey.tolist() == [1, 2]
    assert start.tolist() == [0, 2] and length.tolist() == [2, 1]
    assert first.tolist() == [0, 2]
    assert int(n_keys) == 4 and gid.numel() == 0
    blen, rank = run_histogram(keys, rows.flip(0).long(), np.int32(4))
    assert blen.tolist() == [0, 2, 1, 3]
    # ranks in sorted order 0 1 0 0 1 2 3 (the dead 4 counts from the last
    # head), written through the reversed rows
    assert rank.tolist() == [3, 2, 1, 0, 0, 1, 0]


def test_main_chains_sort_nothing_and_tally_their_groups(monkeypatch):
    """``_main_chains`` on the device path (an exp-4 Ndu build's shape,
    small; MC faked, the operands taken for a card's) makes one MC launch
    over the whole directory under ``hj.build.runs``, with no sort, no
    ``run_histogram`` call and no ``hj.build.sort`` span."""
    from torch.profiler import ProfilerActivity, profile

    keys = column("duplicates", 3000, 17)
    skey, srow, nk = sort_with_rows(keys)
    groups = compact_group_index(keys, skey, srow, 1024)
    assert int(nk) < 1024  # padding groups take part
    launches = []

    def refuse(*a, **k):
        raise AssertionError("a sort in _main_chains")

    real_device = kernels.kernel_device
    monkeypatch.setattr(kernels, "kernel_device", lambda name, *t, **k: (
        0 if name == "main_chains" else real_device(name, *t, **k)))
    monkeypatch.setattr(kernels, "stream", lambda dev: 0)
    monkeypatch.setattr(kernels, "lib", lambda: type(
        "Lib", (), {"hj3t_main_chains_scratch": staticmethod(
            lambda cap, nb: 16 * cap + 4 * nb + 64)}))
    monkeypatch.setattr(runs, "_workspace", lambda *a: (1, 0))
    monkeypatch.setattr(runs, "_MC", lambda *a: launches.append(a))
    monkeypatch.setattr(torch, "sort", refuse)
    monkeypatch.setattr(torch, "argsort", refuse)
    monkeypatch.setattr(nested, "run_histogram", refuse, raising=False)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pos, blen = _main_chains(groups, int(nk), "murmur")
    recs = tracing.records()
    tracing.clear()
    monkeypatch.undo()
    assert [a[0] for a in launches] == ["main_chains"]
    assert launches[0][3:5] == (1024, int(nk))  # cap, num_buckets
    assert pos.shape == (1024,) and blen.shape == (int(nk),)
    assert "hj.build.runs" in {r.name for r in recs}
    assert "hj.build.sort" not in {r.name for r in recs}
