"""``hashjoin3d_tpu_torch.join`` on the CPU against
``hashjoin3d_tpu.join(backend="device")``.

Same seeded numpy inputs on both sides, exact equality (integer work: the
tolerance is zero): counters (``num_matches``, ``num_cmps``,
``num_results``) bit-equal, result pairs equal as multisets, for

* ``how`` x ``unique`` x seven key kinds: a u32 permutation (the
  dense-direct plans), dense-domain u32 keys with duplicates (key_direct),
  sparse u32 keys, signed i32 keys with negatives, u64 keys, i64 keys with
  negatives and composite keys (the merged strands);
* ``backend="host"`` raises, ``"auto"`` runs the device path,
  ``device="cuda"`` raises on a host without CUDA; the roofline's strand
  rows rehearsed at a small size.

Every kind but the dense-domain one maps one permutation bijectively, so
the JAX side compiles each strand once a column dtype.  The modes, the
predicates, the hash functors, empty sides and mixed widths are in
``tests/test_torch_api_modes.py``.
"""

import numpy as np
import pytest
import torch

import hashjoin3d_tpu as jhj
from hashjoin3d_tpu.ops.hashing import murmur32_np

import hashjoin3d_tpu_torch as thj
from hashjoin3d_tpu_torch.tools import roofline

N = 1 << 11          # build rows
P = 1 << 12          # probe rows
KINDS = ("u32_perm", "u32_dense", "u32_sparse", "i32", "u64", "i64",
         "composite")
HOWS = [("nested", False), ("chaining", False), ("chaining", True)]


def columns(kind: str):
    """(build keys, probe keys) of a kind: probes hit about 8 in 9 times."""
    rng = np.random.default_rng(0)
    perm = rng.permutation(N).astype(np.uint32)
    fk = rng.integers(0, N + N // 8, P).astype(np.uint32)
    if kind == "u32_dense":
        rng = np.random.default_rng(1)
        return (rng.integers(0, N // 4, N).astype(np.uint32),
                rng.integers(0, N // 4 + N // 32, P).astype(np.uint32))
    maps = {
        "u32_perm": lambda k: k,
        "u32_sparse": murmur32_np,
        "i32": lambda k: k.astype(np.int32) - N // 2,
        "u64": lambda k: k.astype(np.uint64) | np.uint64(0xAB << 40),
        "i64": lambda k: k.astype(np.int64) - N // 2,
        "composite": lambda k: thj.pack2u32(k >> 5, k & 31),
    }
    return maps[kind](perm), maps[kind](fk)


def same_result(got, want, what=""):
    for k in ("num_matches", "num_cmps", "num_results"):
        assert int(getattr(got, k)) == int(getattr(want, k)), (what, k)
    assert got.probe_rows.dtype == np.int32
    assert got.build_rows.dtype == np.int32
    assert sorted(got.pairs()) == sorted(want.pairs()), what


@pytest.mark.parametrize("how,unique", HOWS)
@pytest.mark.parametrize("kind", KINDS)
def test_join_matches_jax(kind, how, unique):
    bk, pk = columns(kind)
    want = jhj.join(bk, pk, how=how, unique=unique, backend="device")
    got = thj.join(bk, pk, how=how, unique=unique, device="cpu")
    same_result(got, want, kind)
    assert got.route_worst == 0
    assert want.num_results > 0


def test_backends_and_devices():
    bk, pk = columns("u32_dense")
    with pytest.raises(NotImplementedError, match="host"):
        thj.join(bk, pk, backend="host", device="cpu")
    same_result(thj.join(bk, pk, backend="auto", device="cpu"),
                jhj.join(bk, pk, backend="device"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            thj.join(bk, pk)
    with pytest.raises(ValueError, match="inchain"):
        thj.join(bk, pk, predicate=lambda p, b: p["key"] == b["key"],
                 predicate_mode="inchain", hashfun=lambda k: k, device="cpu")
    with pytest.raises(ValueError):
        thj.join(bk, pk, how="cuckoo", device="cpu")


def test_roofline_strand_rows_rehearsed_on_the_cpu():
    d = roofline.inputs("cpu", 12, 10)
    rows = roofline.strand_rows(d)
    assert [r.name.split(" (")[0] for r in rows] == [
        "u32 keydirect nested strand", "u32 merged nested strand",
        "u64 merged nested strand"]
    for r in rows:
        out = r.fn()
        assert r.check(out), r.name
        assert int(out["c_unnest"]) == 1 << 12
