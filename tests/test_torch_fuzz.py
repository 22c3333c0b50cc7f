"""The port's randomized differential fuzzers on the CPU.

``hashjoin3d_tpu_torch/tools/fuzz_api.py``, ``fuzz_stream.py`` and
``fuzz_order.py`` (``fuzz_dist.py`` and ``zipf_capacity.py``: their gloo
ranks are in ``tests/test_torch_fuzz_dist.py``) hold:

* the oracle copy (``tools/oracle.py``) equal to ``tests/oracle.py``:
  counters, emitted sequences and statistics, seeded cases;
* the small tier's generators equal to the JAX fuzzers' own draws: each
  JAX trial function runs on the same seeded numpy generator up to the
  call that follows its last draw, where a stand-in reads the function's
  locals; the case arrays are byte-equal, the config equal, and the two
  generators end each trial in the same state;
* the port's call on the CPU equal to the JAX package's on a few drawn
  cases: counters bit-equal, pairs (emission sequences for the order
  fuzzer) equal;
* each fuzzer's small tier passing a handful of trials, and its large tier
  at a cut size (2^14 rows) against the native host engine;
* a planted fault (two emitted rows swapped, a probe's last row dropped)
  failing a trial that the message names with its seed and replay;
* the large tier's route prediction against the sorts the strands make,
  and the probe sort at 2^23 keys over a 2^21 domain (a segment K1 cannot
  take) on the library sort.

Integer results: the tolerance is zero.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import hashjoin3d_tpu
from hashjoin3d_tpu.ops import chaining as jax_chaining
from hashjoin3d_tpu.ops import nested as jax_nested
from hashjoin3d_tpu.ops import streaming as jax_streaming

from hashjoin3d_tpu_torch import api
from hashjoin3d_tpu_torch.ops import streaming, strands_windowed
from hashjoin3d_tpu_torch.tools import (fuzz_api, fuzz_order, fuzz_stream,
                                        fuzzing)
from hashjoin3d_tpu_torch.tools import oracle as port_oracle

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
sys.path.insert(0, str(TESTS))
import oracle as test_oracle  # noqa: E402


def jax_tool(name):
    """``tools/<name>.py``, the JAX fuzzer, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Captured(Exception):
    """Raised by a stand-in: the calling trial function's locals and the
    stand-in's arguments."""

    def __init__(self, frame_locals, args, kwargs):
        super().__init__("captured")
        self.locals, self.args, self.kwargs = dict(frame_locals), args, kwargs


def capture(*args, **kwargs):
    raise Captured(sys._getframe(1).f_locals, args, kwargs)


def same_array(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def same_state(a, b) -> bool:
    return a.bit_generator.state == b.bit_generator.state


# -- the oracle copy ----------------------------------------------------------

def oracle_case(seed):
    rng = np.random.default_rng(seed)
    n_b, n_p = int(rng.integers(200, 600)), int(rng.integers(300, 900))
    dom = int(rng.integers(8, 2 * n_b))
    bk = rng.integers(0, dom, n_b, dtype=np.uint32)
    bk[: n_b // 4] = bk[0]
    pk = rng.integers(0, dom + dom // 4, n_p, dtype=np.uint32)
    hf = (None if seed % 2 == 0
          else fuzzing.oracle_hash(("fib", "identity")[seed % 4 // 2],
                                   False))
    return bk, pk, int(rng.integers(1, dom)), hf


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["chaining", "chaining unique", "nested"])
def test_oracle_copy_matches_tests_oracle(kind, seed):
    """Counters, the emitted (probe_row, build_row) sequence in walk order,
    a predicate walk and the statistics, under murmur and a callable."""
    bk, pk, nb, hf = oracle_case(seed)
    kw = {} if hf is None else dict(hashfun=hf)

    def pred(p, r):
        return (p + r) % 3 != 0

    if kind.startswith("chaining"):
        unique = kind.endswith("unique")
        got, want = (m.ChainingOracle(bk, nb, **kw)
                     for m in (port_oracle, test_oracle))
        assert got.probe(pk, unique=unique) == want.probe(pk, unique=unique)
        assert (got.probe(pk, unique=unique, predicate=pred)
                == want.probe(pk, unique=unique, predicate=pred))
    else:
        got, want = (m.NestedOracle(bk, nb, **kw)
                     for m in (port_oracle, test_oracle))
        (gn, gm, gc), (wn, wm, wc) = got.probe(pk), want.probe(pk)
        assert (gm, gc) == (wm, wc)
        assert (port_oracle.NestedOracle.unnest(gn)
                == test_oracle.NestedOracle.unnest(wn))
        assert ([(p, m["first_row"]) for p, m in got.probe(pk, pred)[0]]
                == [(p, m["first_row"]) for p, m in want.probe(pk, pred)[0]])
    assert got.stats() == want.stats()
    xs = np.random.default_rng(seed).integers(0, 1 << 32, 64)
    assert ([port_oracle.murmur32_py(int(x)) for x in xs]
            == [test_oracle.murmur32_py(int(x)) for x in xs])


# -- the small tier's draws against the JAX fuzzers' --------------------------

@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_fuzz_api_draws_match_jax(monkeypatch, seed):
    """``tools/fuzz_api.py``'s ``one_trial`` up to its ``join`` call."""
    tool = jax_tool("fuzz_api")
    monkeypatch.setattr(hashjoin3d_tpu, "join", capture)
    jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
    for trial in range(12):
        with pytest.raises(Captured) as e:
            tool.one_trial(jrng, trial)
        loc = e.value.locals
        case = fuzz_api.small_case(prng, trial)
        assert same_array(case.bk, loc["bk"])
        assert same_array(case.pk, loc["pk"])
        for k in ("how", "unique", "mode", "hf", "num_buckets", "kw",
                  "backend", "dist_b", "dist_p", "dtype"):
            assert getattr(case, k) == loc[k], (trial, k)
        assert same_state(prng, jrng), trial


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_fuzz_stream_draws_match_jax(monkeypatch, seed):
    """``tools/fuzz_stream.py``'s ``one_trial`` up to its table build (its
    config string is made before)."""
    tool = jax_tool("fuzz_stream")
    monkeypatch.setattr(jax_chaining, "build_chaining_host", capture)
    monkeypatch.setattr(jax_nested, "build_nested_host", capture)
    jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
    for trial in range(12):
        with pytest.raises(Captured) as e:
            tool.one_trial(jrng, trial)
        loc = e.value.locals
        case = fuzz_stream.small_case(prng, trial)
        assert same_array(case.bk, loc["bk"])
        assert same_array(case.pk, loc["pk"])
        assert case.cfg == loc["cfg"]
        assert (case.nbkt, case.kw) == (loc["nbkt"], loc["kw"])
        assert same_state(prng, jrng), trial


def order_stand_ins(monkeypatch):
    """The clarity ops ``tools/fuzz_order.py`` calls, standing in: builds
    return nothing, probes the oracle's counters (the trial function's
    locals), the expansions raise :class:`Captured` after the last draw."""
    def probe(*args, **kwargs):
        loc = sys._getframe(1).f_locals
        return SimpleNamespace(num_matches=loc["matches"],
                               num_cmps=loc["cmps"],
                               group_len=np.zeros(1, np.int32))

    for mod, names in ((jax_nested, ("build_nested", "build_nested_host")),
                       (jax_chaining, ("build_chaining",
                                       "build_chaining_host"))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, **k: None)
    monkeypatch.setattr(jax_nested, "probe_nested", probe)
    monkeypatch.setattr(jax_chaining, "probe_chaining", probe)
    monkeypatch.setattr(jax_nested, "unnest", capture)
    monkeypatch.setattr(jax_chaining, "materialize_chaining_join", capture)


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_fuzz_order_draws_match_jax(monkeypatch, seed):
    """``tools/fuzz_order.py``'s ``one_trial`` up to its expansion, which
    follows the last two draws (the method / unique flag and the buffer's
    slack)."""
    tool = jax_tool("fuzz_order")
    order_stand_ins(monkeypatch)
    jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
    for trial in range(12):
        with pytest.raises(Captured) as e:
            tool.one_trial(jrng, trial)
        loc, args = e.value.locals, e.value.args
        case = fuzz_order.small_case(prng, trial)
        assert same_array(case.bk, loc["bk"])
        assert same_array(case.pk, loc["pk"])
        for k in ("how", "builder", "kw", "dom", "nbkt"):
            assert getattr(case, k) == loc[k], (trial, k)
        if case.how == "nested":
            assert case.method == loc["method"]
            assert args[2] == 1 + case.slack  # max(total, 1) + slack, total 0
        else:
            assert case.unique == loc["unique"]
            want = (case.pk.size if case.out_kind == "probes"
                    else max(loc["matches"], 1) + case.slack)
            assert max(want, loc["matches"]) == loc["out_size"]
        assert same_state(prng, jrng), trial


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_fuzz_dist_draws_match_jax(monkeypatch, seed):
    """``tools/fuzz_dist.py``'s ``one_trial`` (``--devices 4``) with the
    mesh and the joins standing in: the flat join answers from the
    trial's own ground truth, the second schedule raises after the last
    draw; undersized trials end at the flat join."""
    from hashjoin3d_tpu import parallel as jpar

    from hashjoin3d_tpu_torch.tools import fuzz_dist

    tool = jax_tool("fuzz_dist")
    seen = {}

    def flat(*args, **kwargs):
        def step(bk, pk):
            loc = sys._getframe(1).f_locals
            seen.clear()
            seen.update(loc)
            want = loc["want"]
            rows = np.asarray(want, np.int32).reshape(-1, 2)
            return dict(overflow=int(loc["undersize"]),
                        num_matches=loc["matches"], num_unnested=len(want),
                        probe_row=rows[:, 0], build_row=rows[:, 1],
                        out_valid=np.ones(len(want), bool))
        return step

    monkeypatch.setattr(jpar, "make_mesh", lambda nd: None)
    monkeypatch.setattr(jpar, "shard_axis", lambda mesh: None)
    monkeypatch.setattr(jpar, "dist_nested_join", flat)
    for name in ("dist_chaining_join", "dist_ring_nested_join",
                 "make_mesh_2d"):
        monkeypatch.setattr(jpar, name, capture)
    jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
    for trial in range(10):
        try:
            tool.one_trial(jrng, trial, 4)
            loc = seen
        except Captured as e:
            loc = e.locals
        case = fuzz_dist.small_case(prng, trial, 4)
        assert same_array(case.bk, loc["bk"])
        assert same_array(case.pk, loc["pk"])
        for k in ("nd", "wide", "dom", "dist", "undersize", "nbkt", "kw",
                  "bcap", "ocap"):
            assert getattr(case, k) == loc[k], (trial, k)
        assert case.pcap == loc["pcap_run"]
        assert case.matches == loc["matches"]
        assert np.array_equal(case.want, fuzzing.list_keys(loc["want"]))
        if not case.undersize:
            assert case.other == loc["other"]
        assert same_state(prng, jrng), trial


# -- the port's calls against the JAX package's, on the CPU -------------------

def drawn(gen, seed, trials, keep):
    rng = np.random.default_rng(seed)
    cases = [gen(rng, t) for t in range(trials)]
    return [c for c in cases if keep(c)]


def test_fuzz_api_cases_match_jax_join():
    """Two drawn cases (a u32 nested inner join, a u64 chaining inner or
    left join) through ``hashjoin3d_tpu.join`` and the port's ``join`` on
    the CPU, both on the device path."""
    cases = drawn(fuzz_api.small_case, 11, 40,
                  lambda c: c.kw.get("key_domain", 0) < 1 << 20)
    kinds = (lambda c: (c.how, c.mode, c.dtype) == ("nested", "inner",
                                                    np.uint32),
             lambda c: (c.how == "chaining" and c.mode in ("inner", "left")
                        and c.dtype == np.uint64))
    for c in [next(c for c in cases if kind(c)) for kind in kinds]:
        kw = dict(how=c.how, unique=c.unique, num_buckets=c.num_buckets,
                  mode=c.mode, hashfun=c.hf, backend="device", **c.kw)
        want = hashjoin3d_tpu.join(c.bk, c.pk, **kw)
        got = api.join(c.bk, c.pk, device="cpu", **kw)
        for k in ("num_matches", "num_cmps", "num_results"):
            assert int(getattr(got, k)) == int(getattr(want, k)), (c.cfg, k)
        assert np.array_equal(
            fuzzing.pair_keys(got.probe_rows, got.build_rows),
            fuzzing.pair_keys(want.probe_rows, want.build_rows)), c.cfg


def test_fuzz_stream_cases_match_jax_stream():
    """Four drawn cases, one a layout, through the JAX package's streams
    and the port's."""
    cases = drawn(fuzz_stream.small_case, 5, 24, lambda c: True)
    picked = [next(c for c in cases if c.layout == lay)
              for lay in fuzz_stream.LAYOUTS]
    for c in picked:
        out = 16 * c.chunk + 16
        got = fuzz_stream.stream(c, "cpu", out)
        if c.how == "chaining":
            jt = jax_chaining.build_chaining_host(c.bk, c.nbkt, **c.kw)
            m, cm, pairs = jax_streaming.stream_probe_chaining(
                jt, c.pk, chunk_size=c.chunk, unique=c.unique,
                collect_pairs=True, out_per_chunk=out)
            u = None
        else:
            jt = jax_nested.build_nested_host(c.bk, c.nbkt, **c.kw)
            m, cm, u, pairs = jax_streaming.stream_probe_nested(
                jt, c.pk, chunk_size=c.chunk, collect_pairs=True,
                out_per_chunk=out)
        keys = fuzzing.pair_keys(
            np.concatenate([p for p, _ in pairs] or [np.zeros(0)]),
            np.concatenate([b for _, b in pairs] or [np.zeros(0)]))
        fuzz_stream.compare(c, got, (m, cm, u, keys))


def test_fuzz_order_cases_match_jax_ops():
    """Four drawn cases (nested and chaining, both builders) through the
    JAX package's clarity ops and the port's: counters and every probe
    row's emitted sequence."""
    cases = drawn(fuzz_order.small_case, 3, 24, lambda c: True)
    picked = [next(c for c in cases if (c.how, c.builder) == kind)
              for kind in (("nested", "padded"), ("nested", "host"),
                           ("chaining", "padded"), ("chaining", "host"))]
    for c in picked:
        m, cm, tot, (gp, gb) = fuzz_order.run_case(c, "cpu")
        if c.how == "nested":
            jt = (jax_nested.build_nested(c.bk, c.nbkt)
                  if c.builder == "padded"
                  else jax_nested.build_nested_host(c.bk, c.nbkt, **c.kw))
            res = (jax_nested.probe_nested(jt, c.pk) if c.method == "default"
                   else jax_nested.probe_nested(jt, c.pk, method="merge"))
            total = int(np.sum(np.asarray(jax.device_get(res.group_len))))
            prow, brow, valid, jtot = jax_nested.unnest(
                jt, res, max(total, 1) + c.slack)
        else:
            jt = (jax_chaining.build_chaining(c.bk, c.nbkt)
                  if c.builder == "padded"
                  else jax_chaining.build_chaining_host(c.bk, c.nbkt,
                                                        **c.kw))
            res = jax_chaining.probe_chaining(jt, c.pk, unique=c.unique)
            matches = int(res.num_matches)
            size = (c.pk.size if c.out_kind == "probes"
                    else max(matches, 1) + c.slack)
            prow, brow, valid, jtot = jax_chaining.materialize_chaining_join(
                jt, res, max(size, matches), unique=c.unique)
        wp, wb = fuzz_order.sequences(*jax.device_get((prow, brow, valid)))
        assert (m, cm, tot) == (int(res.num_matches), int(res.num_cmps),
                                int(jtot)), c.cfg
        assert np.array_equal(gp, wp) and np.array_equal(gb, wb), c.cfg


# -- the tiers on the CPU -----------------------------------------------------

FUZZERS = {"fuzz_api": fuzz_api, "fuzz_stream": fuzz_stream,
           "fuzz_order": fuzz_order}


@pytest.mark.parametrize("name", list(FUZZERS))
def test_small_tier_passes(name):
    lines = []
    out = FUZZERS[name].run("cpu", 10, 20261017, "small", lines.append)
    assert out["small"]["trials"] == 10
    assert lines[-1] == "ALL 10 SMALL TRIALS PASSED (seed 20261017)"


@pytest.mark.parametrize("name", list(FUZZERS))
def test_large_tier_passes_at_a_cut_size(name):
    """Four large trials with every column cut to 2^14 rows, checked
    against the native host engine; the reach is reported, not asserted,
    at a cut size."""
    lines = []
    out = FUZZERS[name].run("cpu", 4, 7, "large", lines.append, cut=14)
    assert out["large"]["reach"]["k3"] > fuzzing.SCAN_TILE
    assert lines[0].startswith(f"{name} large: the draws reach")
    assert len([x for x in lines if x.startswith("ok large")]) == 4


# -- teeth: a planted fault fails a named trial -------------------------------

def swap_first_two(fn):
    def planted(*args):
        out = fn(*args).clone()
        if out.numel() >= 2:
            out[[0, 1]] = out[[1, 0]]
        return out
    return planted


def drop_last_row(fn):
    def planted(*args, **kwargs):
        bt, pt = fn(*args, **kwargs)
        return bt, pt[:-1]
    return planted


def test_planted_faults_fail_a_named_trial(monkeypatch):
    """Two emitted rows swapped in ``layout.emit_pos`` (the order fuzzer),
    a probe column's last row dropped (``join``'s carriers; a stream's host
    column): each fuzzer raises on a trial, naming it, its config, its seed
    and the command that replays it."""
    from hashjoin3d_tpu_torch.ops import chaining, nested

    pattern = (r"{} small trial \d+ failed on cpu: trial \d+: .* "
               r"\(seed 5; replay: python3 -m hashjoin3d_tpu_torch\.tools\."
               r"{} --seed 5 --tier small --trials \d+ --device cpu\)")
    with monkeypatch.context() as m:
        for mod in (chaining, nested):
            m.setattr(mod, "emit_pos", swap_first_two(mod.emit_pos))
        with pytest.raises(fuzzing.TrialFailure,
                           match=pattern.format("fuzz_order", "fuzz_order")):
            fuzz_order.run("cpu", 40, 5, "small", lambda line: None)
    with monkeypatch.context() as m:
        m.setattr(api, "_carriers", drop_last_row(api._carriers))
        with pytest.raises(fuzzing.TrialFailure,
                           match=pattern.format("fuzz_api", "fuzz_api")):
            fuzz_api.run("cpu", 60, 5, "small", lambda line: None)
    with monkeypatch.context() as m:
        host_column = streaming._host_column
        m.setattr(streaming, "_host_column",
                  lambda pk, wide: host_column(pk, wide)[:-1])
        with pytest.raises(fuzzing.TrialFailure,
                           match=pattern.format("fuzz_stream",
                                                "fuzz_stream")):
            fuzz_stream.run("cpu", 40, 5, "small", lambda line: None)


# -- the large tier's route prediction ----------------------------------------

def test_probe_sort_prediction_matches_the_strands(monkeypatch):
    """``fuzzing.probe_sort`` names the sort ``_sort_probes`` makes, and
    its segment: K1 for keys inside 2^key_bits, K4 past them, the library
    for a length no segment divides."""
    seen = []

    def recorder(kind, fn):
        def rec(keys, chunk, *args, **kwargs):
            seen.append((kind, chunk))
            return fn(keys, chunk, *args, **kwargs)
        return rec

    from hashjoin3d_tpu_torch.ops import sort

    monkeypatch.setattr(strands_windowed, "bitonic_sort_packed_segmented",
                        recorder("K1", strands_windowed
                                 .bitonic_sort_packed_segmented))
    monkeypatch.setattr(sort, "bitonic_sort_segmented",
                        recorder("K4", sort.bitonic_sort_segmented))
    rng = np.random.default_rng(3)
    for P, domain, top in ((1 << 14, 3000, 3000), (1 << 14, 3000, 6000),
                           (1 << 14, 1 << 12, 1 << 12), (12345, 3000, 3000),
                           (1 << 13, 1 << 11, 5000)):
        keys = rng.integers(0, top, P).astype(np.uint32)
        keys[0] = top - 1
        seen.clear()
        strands_windowed._sort_probes(torch.from_numpy(keys.view(np.int32)),
                                      domain=domain)
        kernel, seg = fuzzing.probe_sort(P, domain, int(keys.max()))
        assert seen == ([(kernel, seg)] if kernel else []), (P, domain, top)


def test_probe_sort_past_k1_segments_takes_the_library(monkeypatch):
    """2^23 probe keys over a 2^21 domain take the policy's second cap,
    2^20-key segments, which K1 cannot take: ``_sort_probes`` used to hand
    them to K1 regardless, and its segment check raised ValueError.
    ``fuzz_api``'s large tier reaches it at seed 233, trial 1 (a u32
    nested left join, 453,924 build rows, 8,388,608 probes, key_direct
    domain 1,324,400).  The policy's answer is held at 2^23 keys; the
    sort runs on one such 2^20-key segment (the policy stood in for at
    that length), which now takes the library sort."""
    from hashjoin3d_tpu_torch.ops.sort import probe_sort_chunk

    assert probe_sort_chunk(1 << 23, 1 << 21) == 1 << 20
    assert strands_windowed.packed_key_bits(1 << 20, 1 << 21) is None
    assert strands_windowed.packed_key_bits(1 << 18, 1 << 20) == 20
    assert fuzzing.probe_sort(1 << 23, 1 << 21, 5) == (None, 1 << 20)
    monkeypatch.setattr(strands_windowed, "probe_sort_chunk",
                        lambda P, domain: 1 << 20)
    keys = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << 21, 1 << 20).astype(np.int32))
    out = strands_windowed._sort_probes(keys, domain=1 << 21)
    assert out.segment == 1 << 20
    assert bool((out.skey[1:] >= out.skey[:-1]).all())
    assert torch.equal(keys[out.srow.long()], out.skey)


def test_strand_domain_is_the_domain_join_sorts_over(monkeypatch):
    """``fuzz_api.strand_domain``, from which the large tier asserts its
    K1 / K4 reach, names the domain ``join`` hands the windowed strands'
    probe sort (``_sort_probes``) on drawn large cases at a cut size:
    dense-direct, key_direct and merged routes all occur, and no other
    domain reaches the sort."""
    seen = []
    sort_probes = strands_windowed._sort_probes

    def recorded(pk, domain=None):
        seen.append(domain)
        return sort_probes(pk, domain=domain)

    monkeypatch.setattr(strands_windowed, "_sort_probes", recorded)
    rng = np.random.default_rng(11)
    routes = set()
    for trial in range(16):
        case = fuzz_api.large_case(rng, trial, 12)
        seen.clear()
        fuzz_api.call(case, "cpu", "device")
        want = fuzz_api.strand_domain(case)
        assert set(seen) <= {want} and (want is None or seen), (
            case.cfg, want, seen)
        _, dense, _ = api.device_route(case.bk, case.pk, case.nb_eff,
                                       case.kw.get("key_domain"), case.hf)
        routes.add("merged" if want is None else "dense"
                   if dense and case.how == "chaining" else "key_direct")
    assert routes == {"merged", "dense", "key_direct"}


# -- the entry points ---------------------------------------------------------

def test_entry_points_default_to_cuda_and_import_no_jax():
    """Each tool's ``main`` asks for CUDA by default and raises here (no
    card); importing all five pulls in no ``jax``, no ``hashjoin3d_tpu``
    and nothing of ``tests/``."""
    code = (
        "import sys\n"
        "from hashjoin3d_tpu_torch.tools import (fuzz_api, fuzz_stream, "
        "fuzz_order, fuzz_dist, zipf_capacity)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'hashjoin3d_tpu', 'oracle', 'tests'))\n"
        "print('imports', bad)\n"
        "for mod in (fuzz_api, fuzz_stream, fuzz_order, fuzz_dist):\n"
        "    try:\n"
        "        mod.main(mod.__name__.rsplit('.', 1)[1], mod.run, "
        "mod.__doc__, [])\n"
        "        print('ran', mod.__name__)\n"
        "    except RuntimeError as e:\n"
        "        print('refused', 'is_available() is False' in str(e))\n"
        "try:\n"
        "    zipf_capacity.main([])\n"
        "except RuntimeError as e:\n"
        "    print('refused', 'is_available() is False' in str(e))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["imports []"] + ["refused True"] * 5
