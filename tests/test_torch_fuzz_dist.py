"""The port's distributed fuzzer and zipf-capacity check on 4 gloo ranks.

``hashjoin3d_tpu_torch/tools/fuzz_dist.py`` and ``zipf_capacity.py`` on
the CPU.  The ranks are spawned once for the module
(``tests/torch_ranks.py``; no ``jax`` in them):

* ``fuzz_dist``'s small tier passes (meshes of 1, 2 and 4 ranks) and its
  large tier at a cut size; the tool's own entry point, which spawns its
  ranks, passes a few trials; ``fuzzing.spawn_ranks`` names a rank that
  raised;
* drawn cases, one each second schedule (chaining, ring, 2-D) and an
  undersized one, equal the JAX package's joins on ``make_mesh(nd)`` of
  the virtual CPU devices: every counter (``num_cmps`` and ``overflow``
  included) bit-equal, pairs equal as multisets;
* a result with a pair dropped, a count off or an overflow undetected
  fails the trial's verdict, named by its config;
* ``zipf_capacity``'s receive volumes (``shard_of_key`` and its host
  mirror) equal the JAX tool's host mirror with the JAX package's
  ``detect_skew`` top keys, and its live flat and hybrid joins at R10/S14
  equal the JAX package's: the flat join overflows, the hybrid does not
  and counts |S| matches.

Integer results: the tolerance is zero.
"""

import jax
import numpy as np
import pytest

from hashjoin3d_tpu import parallel as jpar
from hashjoin3d_tpu.ops.hashing import hash_key_np as jax_hash_np

from hashjoin3d_tpu_torch.parallel import detect_skew
from hashjoin3d_tpu_torch.tools import fuzz_dist, fuzzing, zipf_capacity
from hashjoin3d_tpu_torch.utils.gen import exp1_data

from torch_ranks import RankPool

NS = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(NS, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield p
    p.close()


def reports(pool, *args) -> list:
    lines = pool.run("fuzz_dist_trials", *args)
    assert all(not x for x in lines[1:])  # only rank 0 reports
    return lines[0]


def test_small_tier_passes(pool):
    lines = reports(pool, 16, 20261017, "small")
    assert [x[0] for x in lines] == ["line"] * 16 + ["tier"]
    assert all(x[3][0] == "ok" for x in lines[:-1])
    assert {int(x[2].split("nd=")[1].split()[0]) for x in lines[:-1]} == {
        1, 2, 4}


def test_large_tier_passes_at_a_cut_size(pool):
    lines = reports(pool, 4, 3, "large", 12)
    assert [x[0] for x in lines] == ["line"] * 4 + ["tier"]
    assert all(x[3][0] == "ok" for x in lines[:-1])


def test_tool_entry_point_spawns_its_ranks():
    """``fuzz_dist.run`` on the CPU: its own 4 ranks, three small trials."""
    lines = []
    out = fuzz_dist.run("cpu", 3, 11, "small", lines.append)
    assert out["small"]["trials"] == 3
    assert lines[-1] == "ALL 3 SMALL TRIALS PASSED (seed 11)"


def test_spawn_ranks_names_a_rank_that_raised():
    """``fuzzing.spawn_ranks`` passes the ranks' messages on and raises,
    once every rank has exited, with the traceback of a rank that
    raised."""
    import torch_ranks

    seen = []
    with pytest.raises(fuzzing.TrialFailure,
                       match=r"(?s)rank 1:.*planted on rank 1"):
        fuzzing.spawn_ranks(torch_ranks.raising_body, 2, "cpu", 1,
                            on_message=seen.append)
    assert seen == [(0, "rank", 0)]


def jax_schedules(case) -> dict:
    """The JAX package's flat join and second schedule of ``case`` on
    ``make_mesh(nd)``, as ``tools/fuzz_dist.py`` calls them."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jpar.make_mesh(case.nd)
    sh = jpar.shard_axis(mesh)
    bkd, pkd = jax.device_put(case.bk, sh), jax.device_put(case.pk, sh)
    narrow = {k: v for k, v in case.kw.items() if k != "merged"}
    calls = {"flat": lambda: jpar.dist_nested_join(
        mesh, num_buckets_per_shard=case.nbkt, build_capacity=case.bcap,
        probe_capacity=case.pcap, out_capacity=case.ocap,
        **case.kw)(bkd, pkd)}
    if case.other == "chaining":
        calls["other"] = lambda: jpar.dist_chaining_join(
            mesh, num_buckets_per_shard=case.nbkt, build_capacity=case.bcap,
            probe_capacity=case.pcap, out_capacity=case.ocap,
            **narrow)(bkd, pkd)
    elif case.other == "ring":
        calls["other"] = lambda: jpar.dist_ring_nested_join(
            mesh, num_buckets_per_shard=case.nbkt, build_capacity=case.bcap,
            out_capacity=case.ocap, **narrow)(bkd, pkd)
    elif case.other == "2d":
        mesh2 = jpar.make_mesh_2d(2, case.nd // 2)
        sh2 = NamedSharding(mesh2, P(("host", "chip")))
        calls["other"] = lambda: jpar.dist_nested_join_2d(
            mesh2, num_buckets_per_shard=case.nbkt,
            build_capacity=case.bk.size, probe_capacity=case.pk.size,
            out_capacity=case.want.size + 1, **narrow)(
                jax.device_put(case.bk, sh2), jax.device_put(case.pk, sh2))
    out = {}
    for name, call in calls.items():
        o = jax.device_get(call())
        v = np.asarray(o["out_valid"]).ravel()
        out[name] = dict(
            {k: int(x) for k, x in o.items() if np.ndim(x) == 0},
            pairs=fuzzing.pair_keys(np.asarray(o["probe_row"]).ravel()[v],
                                    np.asarray(o["build_row"]).ravel()[v]))
    return out


def test_drawn_cases_match_the_jax_joins(pool):
    """Seed 2026's trials 1, 5, 6 and 11 (2-D, ring and chaining on 4
    ranks, an undersized flat join on 2) on the port's ranks and the JAX
    mesh."""
    seed, trials = 2026, (1, 5, 6, 11)
    rng = np.random.default_rng(seed)
    cases = [fuzz_dist.small_case(rng, t, NS) for t in range(max(trials) + 1)]
    assert ({cases[t].other for t in trials} == {"2d", "chaining", "ring",
                                                 None})
    per_rank = pool.run("fuzz_dist_schedules", seed, list(trials))
    for i, t in enumerate(trials):
        case = cases[t]
        shards = [r[i] for r in per_rank]
        want = jax_schedules(case)
        for name, w in want.items():
            got = [s[name] for s in shards if s]
            for k, v in w.items():
                if k != "pairs":
                    assert all(g[k] == v for g in got), (case.cfg, name, k)
            pairs = np.sort(np.concatenate([g["pairs"] for g in got]))
            assert np.array_equal(pairs, w["pairs"]), (case.cfg, name)
        assert fuzz_dist.verdict(case, shards).startswith("  [")


def test_verdict_names_a_faulty_trial():
    """A dropped pair, an off count and an undetected overflow each fail
    the verdict with the trial's config."""
    rng = np.random.default_rng(2026)
    cases = [fuzz_dist.small_case(rng, t, NS) for t in range(12)]
    case, under = cases[6], cases[11]
    assert under.undersize and not case.undersize
    good = dict(overflow=0, num_matches=case.matches,
                num_unnested=case.want.size, num_results=case.want.size,
                num_cmps=0, pairs=case.want)
    assert fuzz_dist.verdict(case, [dict(flat=good, other=good)]) == (
        "  [+chaining]")
    for fault, what in ((dict(pairs=case.want[1:]), "flat pairs"),
                        (dict(num_matches=case.matches + 1), "matches"),
                        (dict(overflow=3), "overflow")):
        with pytest.raises(fuzzing.TrialFailure, match=what) as e:
            fuzz_dist.verdict(case, [dict(flat={**good, **fault},
                                          other=good)])
        assert str(e.value).startswith(case.cfg)
    with pytest.raises(fuzzing.TrialFailure, match="overflow undetected"):
        fuzz_dist.verdict(under, [dict(flat=good)])


def zipf_columns():
    rk, sa, _ = exp1_data(10, 14, True, 0)
    return rk, sa


def test_zipf_volumes_match_the_jax_tool():
    """Per-(src, dst) volumes of S.a at R10/S14 on 8 and 4 shards, with
    and without the top-16 keys: the port's (``shard_of_key`` and its host
    mirror, which it holds equal) against the JAX tool's host mirror; the
    port's ``detect_skew`` top keys equal the JAX package's."""
    rk, sa = zipf_columns()
    for shards in (8, NS):
        top = detect_skew(sa, shards)["top_keys"]
        assert np.array_equal(np.sort(top), np.sort(
            jpar.detect_skew(sa, shards)["top_keys"]))
        got = zipf_capacity.receive_volumes(sa, shards, top, "cpu")
        d = (jax_hash_np(jax_hash_np(sa)) % np.uint32(shards)).astype(
            np.int64)
        src = np.arange(sa.size) // (sa.size // shards)
        cold = ~np.isin(sa, top)
        for name, w in (("flat", None), ("cold", cold.astype(np.int64))):
            pair = np.bincount(src * shards + d, weights=w,
                               minlength=shards * shards).astype(np.int64)
            assert got[name]["max_pair"] == pair.max()
            assert np.array_equal(got[name]["per_shard"],
                                  pair.reshape(shards, shards).sum(0))
        assert got["hot_rows"] == int((~cold).sum())


def test_zipf_live_joins_match_jax(pool):
    """R10/S14 on 4 ranks at the live run's capacity (the midpoint of the
    cold-only and the flat exchange's largest per-(src, dst) volume): the
    flat join overflows, the hybrid counts |S| matches and unnested rows,
    and every counter equals the JAX package's flat / hybrid join on
    ``make_mesh(4)``."""
    lines = []
    v = zipf_capacity.volumes("cpu", lines.append, 14, 10, NS)
    rk, sa, top = v["rk"], v["sa"], v["top"]
    cap = zipf_capacity.live_capacity(v["volumes"])
    assert (v["volumes"]["cold"]["max_pair"] <= cap
            < v["volumes"]["flat"]["max_pair"])
    got = pool.run("zipf_live", rk, sa, top, cap)
    assert all(g == got[0] for g in got)
    mesh = jpar.make_mesh(NS)
    sh = jpar.shard_axis(mesh)
    common = dict(num_buckets_per_shard=rk.size // NS,
                  build_capacity=rk.size, probe_capacity=cap,
                  out_capacity=2 * (sa.size // NS))
    bkd, pkd = jax.device_put(rk, sh), jax.device_put(sa, sh)
    want = {"flat": jpar.dist_nested_join(mesh, **common)(bkd, pkd),
            "hybrid": jpar.dist_hybrid_nested_join(
                mesh, top, hot_build_capacity=32, **common)(bkd, pkd)}
    for name, w in want.items():
        assert got[0][name] == {k: int(x) for k, x in w.items()
                                if np.ndim(x) == 0}, name
    assert got[0]["flat"]["overflow"] > 0
    assert got[0]["hybrid"]["overflow"] == 0
    assert got[0]["hybrid"]["num_matches"] == sa.size
    assert got[0]["hybrid"]["num_unnested"] == sa.size
