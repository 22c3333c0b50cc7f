"""The port's leftover utils on the CPU against the JAX package.

* ``utils/checkpoint.py``: a ``save_table`` / ``load_table`` round trip of
  each table kind of the port (dense-direct, compacted with and without
  ``key_direct``, u64; chaining and nested; a bare ``GroupIndex``), field
  for field and through a probe, and a file written by the JAX package's
  ``save_table`` loaded by the port equal to ``convert.py``'s table;
* ``utils/tracing.py``: ``trace`` and ``checked`` on the CPU (the spans
  and host-read counters: ``tests/test_torch_tracing.py``);
* ``utils/misc.py`` against the JAX package's helpers;
* ``utils/gen.py`` / ``utils/mt19937.py``: ``mt19937_stream`` in both
  backends, ``gen_rand_int_vec`` against the JAX package's python backend
  and between the port's two backends on all eight distributions, and the
  ``tests/test_generators.py`` cases (the reference's relation dumps).

Integer work: exact equality throughout.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_chaining
from hashjoin3d_tpu.ops.nested import build_nested_host as jax_nested
from hashjoin3d_tpu.utils import checkpoint as jckpt
from hashjoin3d_tpu.utils import gen as jgen
from hashjoin3d_tpu.utils import misc as jmisc

from hashjoin3d_tpu_torch.convert import (CHAINING_FIELDS, FIELDS,
                                          NESTED_FIELDS, OPTIONAL_FIELDS,
                                          chaining_table_from_numpy,
                                          nested_table_from_numpy)
from hashjoin3d_tpu_torch.ops.chaining import build_chaining_host
from hashjoin3d_tpu_torch.ops.layout import key_column, key_group_index
from hashjoin3d_tpu_torch.ops.nested import build_nested_host
from hashjoin3d_tpu_torch.ops.strands_windowed import (
    direct_probe_strand_sorted, keydirect_nested_strand_sorted,
    merged_chaining_strand_sorted)
from hashjoin3d_tpu_torch.utils import gen, misc
from hashjoin3d_tpu_torch.utils.checkpoint import load_table, save_table
from hashjoin3d_tpu_torch.utils.tracing import checked, trace

GOLDEN = Path(__file__).parent / "golden"


def same_object(a, b, path="root"):
    """Field-for-field equality of two port dataclasses (tensors equal in
    dtype and values)."""
    assert type(a) is type(b), path
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same_object(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def tables():
    rng = np.random.default_rng(11)
    perm = rng.permutation(1024).astype(np.uint32)
    dup = rng.integers(0, 300, 2048).astype(np.uint32)
    wide = dup.astype(np.uint64) | (np.uint64(0x3C) << np.uint64(40))
    col = lambda a: key_column(a, "cpu")  # noqa: E731
    return {
        "chaining dense": build_chaining_host(col(perm), 700,
                                              dense_direct=True, n_keys=1024,
                                              full_chain_index=True),
        "chaining key_direct": build_chaining_host(col(dup), 200, n_keys=300,
                                                   key_domain=320),
        "chaining u64": build_chaining_host(col(wide), 200,
                                            early_exit_index=False,
                                            hashfun="boncz"),
        "nested dense": build_nested_host(col(perm), 512, dense_direct=True,
                                          n_keys=1024),
        "nested key_direct": build_nested_host(col(dup), 150, n_keys=300,
                                               key_domain=300),
        "nested u64": build_nested_host(col(wide), 150, hashfun="fib"),
        "groups": key_group_index(col(dup)),
    }


@pytest.mark.parametrize("kind", list(tables()))
def test_checkpoint_round_trip(kind, tmp_path):
    table = tables()[kind]
    save_table(tmp_path / "t", table)
    assert (tmp_path / "t.npz").exists() and (tmp_path / "t.json").exists()
    back = load_table(tmp_path / "t", device="cpu")
    same_object(back, table)


def test_checkpoint_loaded_table_probes_the_same(tmp_path):
    rng = np.random.default_rng(2)
    t = tables()
    pk = key_column(rng.integers(0, 1100, 4000).astype(np.uint32), "cpu")
    wide = key_column(rng.integers(0, 320, 4000).astype(np.uint64)
                      | (np.uint64(0x3C) << np.uint64(40)), "cpu")
    for name, probe in (
            ("chaining dense",
             lambda tb: direct_probe_strand_sorted(tb, pk, unique=False)),
            ("nested key_direct",
             lambda tb: keydirect_nested_strand_sorted(tb, pk, 1 << 15)),
            ("chaining u64",
             lambda tb: merged_chaining_strand_sorted(tb, wide, 1 << 15))):
        save_table(tmp_path / name.replace(" ", "_"), t[name])
        back = load_table(tmp_path / name.replace(" ", "_"), device="cpu")
        a, b = probe(t[name]), probe(back)
        for k in ("c_htProbe", "c_htProbeCmp", "total"):
            assert int(a[k]) == int(b[k]), (name, k)
        assert torch.equal(a["probe_row"], b["probe_row"]), name


def jax_fields(table, names):
    out = {}
    for f in names:
        obj = table
        for part in f.split("."):
            obj = getattr(obj, part)
        out[f] = np.asarray(obj) if obj is not None else None
    return out


@pytest.mark.parametrize("kind", ["chaining dense", "chaining key_direct",
                                  "nested key_direct", "nested u64"])
def test_jax_written_table_loads(kind, tmp_path):
    """A table the JAX package saved loads as ``convert.py`` carries it."""
    rng = np.random.default_rng(4)
    perm = rng.permutation(1024).astype(np.uint32)
    dup = rng.integers(0, 300, 2048).astype(np.uint32)
    if kind == "chaining dense":
        jt = jax_chaining(perm, 700, dense_direct=True, n_keys=1024,
                          full_chain_index=True)
        want = chaining_table_from_numpy(
            jax_fields(jt, tuple(dict.fromkeys(FIELDS + CHAINING_FIELDS
                                               + OPTIONAL_FIELDS))),
            num_buckets=700,
            hashfun="murmur", device="cpu", direct_shift=jt.direct_shift)
    elif kind == "chaining key_direct":
        jt = jax_chaining(dup, 200, n_keys=300, key_domain=320)
        want = chaining_table_from_numpy(
            jax_fields(jt, CHAINING_FIELDS + OPTIONAL_FIELDS),
            num_buckets=200, hashfun="murmur", device="cpu")
    else:
        keys = dup if kind == "nested key_direct" else (
            dup.astype(np.uint64) | (np.uint64(0x3C) << np.uint64(40)))
        kw = dict(key_domain=300) if kind == "nested key_direct" else {}
        jt = jax_nested(keys, 150, n_keys=300, **kw)
        want = nested_table_from_numpy(
            jax_fields(jt, NESTED_FIELDS), num_buckets=150,
            hashfun="murmur", device="cpu")
    jckpt.save_table(tmp_path / "jax", jt)
    got = load_table(tmp_path / "jax", device="cpu")
    same_object(got, want)


def test_checkpoint_refusals(tmp_path):
    save_table(tmp_path / "g", tables()["groups"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            load_table(tmp_path / "g")  # the default device is CUDA
    spec = (tmp_path / "g.json").read_text().replace(
        "hashjoin3d_tpu_torch.ops.layout", "os")
    (tmp_path / "g.json").write_text(spec)
    with pytest.raises(ValueError, match="not a class of this package"):
        load_table(tmp_path / "g", device="cpu")
    with pytest.raises(TypeError, match="cannot save"):
        save_table(tmp_path / "h", dataclasses.replace(
            tables()["nested dense"], hashfun=lambda k: k))


def test_tracing_on_the_cpu(tmp_path):
    x = torch.arange(10, dtype=torch.float64)
    with trace(tmp_path / "prof") as prof:
        y = (x * 2).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert prof.key_averages() is not None and float(y) == 90.0
    err, out = checked(lambda t: t * 3)(x)
    assert err.get() is None and int(out[1]) == 3
    err.throw()  # clean: nothing raised
    err, out = checked(lambda t, i: t[i])(x, torch.tensor([11]))
    assert out is None and "out of bounds" in err.get()
    with pytest.raises(IndexError):
        err.throw()
    err, out = checked(lambda t: {"r": [t / t]})(x)  # 0 / 0 at row 0
    assert "nan" in err.get() and "['r'][0]" in err.get()
    with pytest.raises(FloatingPointError):
        err.throw()


def test_misc_helpers_match_jax():
    for n in (0, 1, 9, 10, 99, 12345, -77):
        for base in (2, 10, 16):
            assert misc.number_of_digits(n, base) == \
                jmisc.number_of_digits(n, base)
    for x in (-1, 0, 1, 8, 27, 81, 100, 1 << 20):
        for base in (2, 3, 10):
            assert misc.is_power_of(x, base) == jmisc.is_power_of(x, base)
    assert (misc.factorial(10), misc.binomial(10, 3)) == (
        jmisc.factorial(10), jmisc.binomial(10, 3))
    assert misc.indent(3) == jmisc.indent(3) == "      "
    for f in ("ltrim", "rtrim", "trim", "to_lower", "to_upper"):
        assert getattr(misc, f)("  MiXed \t") == getattr(jmisc, f)(
            "  MiXed \t")
    for s in (123.0, 0.0123, 4.5e-5, 2e-8, 0.0):
        assert misc.duration_str(s) == jmisc.duration_str(s)
    a = np.zeros((4, 1024), np.uint32)
    assert misc.type_name({"k": a, "v": [a[0], (1, "x")]}) == \
        jmisc.type_name({"k": a, "v": [a[0], (1, "x")]})
    assert misc.type_name(torch.zeros(3, dtype=torch.int32)) == \
        "torch.int32[3]"


def test_mt19937_streams():
    py = gen.mt19937_stream(2000, backend="python")
    assert (int(py[0]), int(py[1])) == (3499211612, 581869302)
    np.testing.assert_array_equal(py, gen.mt19937_stream(2000))
    np.testing.assert_array_equal(gen.mt19937_stream(700, seed=7),
                                  gen.mt19937_stream(700, seed=7,
                                                     backend="python"))
    np.testing.assert_array_equal(
        py, jgen.mt19937_stream(2000, backend="python"))
    with pytest.raises(ValueError, match="backend"):
        gen.mt19937_stream(4, backend="tpu")


#: (dist, card, maxv, shift, param, flags, order): test_generators.py's
#: cases, exp and norm with fill + shuffle + permute, and pois in both of
#: libstdc++'s regimes
GEN_CASES = [
    ("key", 128, 64, 0, 0.0, 0, -1), ("div", 128, 0, 0, 4.0, 0, 0),
    ("uni", 128, 32, 0, 0.0, 0, 0), ("uni", 128, 32, 0, 0.0, 1, 0),
    ("zipf", 128, 50, 0, 1.0, 0, -1), ("zipf", 128, 50, 0, 0.8, 2, 0),
    ("self", 128, 40, 0, 0.2, 0, 0), ("exp", 1000, 400, 0, 2.0, 0, 1),
    ("exp", 1500, 300, 0, 2.0, 3, -1), ("norm", 1000, 400, 0, 50.0, 0, 0),
    ("norm", 1500, 300, 0, 50.0, 3, -1), ("pois", 1000, 10**6, 0, 4.5, 0, 0),
    ("pois", 1000, 10**6, 0, 100.0, 0, 0), ("pois", 1500, 300, 7, 150.0, 3, -1),
]


@pytest.mark.parametrize("case", GEN_CASES, ids=lambda c: f"{c[0]}-{c[5]}")
def test_gen_rand_int_vec_backends_and_jax(case):
    dist, card, maxv, shift, param, flags, order = case
    nat = gen.gen_rand_int_vec(dist, card, maxv, shift, param, flags, order)
    py = gen.gen_rand_int_vec(dist, card, maxv, shift, param, flags, order,
                              backend="python")
    np.testing.assert_array_equal(nat, py)
    np.testing.assert_array_equal(
        py, jgen.gen_rand_int_vec(dist, card, maxv, shift, param, flags,
                                  order, backend="python"))
    assert nat.dtype == np.uint32 and nat.size == card
    seeded = gen.gen_rand_int_vec(dist, card, maxv, shift, param, flags,
                                  order, seed=99)
    np.testing.assert_array_equal(
        seeded, gen.gen_rand_int_vec(dist, card, maxv, shift, param, flags,
                                     order, seed=99, backend="python"))


def _relation(path, col):
    return np.array([int(line.split("|")[col])
                     for line in path.read_text().splitlines()], np.uint32)


@pytest.mark.parametrize("name,skew,t", [("e1_R4_S6_t1_uni", False, 1),
                                         ("e1_R4_S6_t0_zipf", True, 0)])
def test_exp1_data_matches_reference_dump(name, skew, t):
    rk, sa, _ = gen.exp1_data(4, 6, skew, t)
    np.testing.assert_array_equal(rk, _relation(GOLDEN / name / "R.txt", 0))
    np.testing.assert_array_equal(sa, _relation(GOLDEN / name / "S.txt", 1))


def test_exp4_data_matches_reference_dump():
    sa, ta = gen.exp4_data(4, 1, 2, 2, 3)
    d = GOLDEN / "e4_R4_a1_A2_b2_B3"
    np.testing.assert_array_equal(sa, _relation(d / "S.txt", 1))
    np.testing.assert_array_equal(ta, _relation(d / "T.txt", 1))
