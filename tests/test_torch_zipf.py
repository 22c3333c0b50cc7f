"""Exp-1 under zipf(1.0) foreign keys on the CPU, and what a windowed
lookup that loses its windows records.

* the benchmark's zipf recipe (``bench_cuda/recipes/exp1_zipf.py``): R a
  permutation, S inside the domain, the same for one seed and other for
  another, and the hottest key's share near 1/H_N;
* the port's Csr and Nrs through the benchmark's entry
  (``bench_cuda/entries/exp1_plan.py``) on the small zipf copy: counters
  and pairs equal to the plain reference's (``references/two_way.py``);
* the same skewed columns handed to the JAX package's ``Experiment1``:
  Csr's and Nrs's counters equal the port's;
* ``safe_lookup`` on a skewed sorted stream leaves route 0: the open span
  tallies its uncovered chunks (``lookup.uncovered``, the strand's
  ``route_nbad``) and times the re-gather once (``lookup.regather``),
  with its host reads unchanged; a stream its
  windows cover tallies nothing, and outside a profiler window nothing
  is recorded.
"""

import csv
import io
import json
import math

import numpy as np
import pytest
import torch

from bench_cuda import spec
from bench_cuda.entries import exp1_plan
from bench_cuda.harness import Context
from bench_cuda.recipes import exp1_zipf, instance_seed
from bench_cuda.references import two_way
from hashjoin3d_tpu_torch.ops.strands_windowed import (_with_route,
                                                       safe_lookup)
from hashjoin3d_tpu_torch.ops.windowed import windowed_lookup_covered
from hashjoin3d_tpu_torch.utils import tracing

from test_torch_tracing import profiled

CPU = torch.device("cpu")
CONFIG = json.loads(
    (spec.HERE / "configs" / "exp1-R20S24-zipf.json").read_text())
SMALL = dict(CONFIG, **exp1_zipf.small(CONFIG))


def traffic(name: str) -> dict:
    return json.loads((spec.HERE / "workloads" / f"{name}.json").read_text())


def columns(seed: int) -> dict:
    return exp1_zipf.columns(SMALL, instance_seed(seed, 0), CPU)


def test_the_recipe_draws_zipf_keys_over_the_domain():
    n_r, n_s = SMALL["rows"]["R"], SMALL["rows"]["S"]
    assert (SMALL["log2_card_r"], SMALL["log2_card_s"]) == (10, 14)
    a, b, c = columns(3), columns(3), columns(4)
    assert a["R"].dtype == a["S"].dtype == torch.int32
    assert torch.equal(torch.sort(a["R"]).values,
                       torch.arange(n_r, dtype=torch.int32))
    s = a["S"]
    assert s.numel() == n_s and 0 <= int(s.min()) and int(s.max()) < n_r
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["S"], c["S"])
    # rank 1 is key 0, drawn with probability 1 / H_N
    counts = torch.bincount(s.long(), minlength=n_r)
    p = 1 / sum(1 / k for k in range(1, n_r + 1))
    assert int(counts.argmax()) == 0
    assert abs(int(counts[0]) / n_s - p) < 4 * math.sqrt(p * (1 - p) / n_s)
    # no fill: the draw leaves some of the domain's keys out
    assert int((counts == 0).sum()) > 0


def _port(plan_traffic: dict, cols: dict) -> dict:
    plan = exp1_plan.prepare(Context(SMALL, plan_traffic, CPU), cols)
    return exp1_plan.query(plan, lambda phase: None)


@pytest.mark.parametrize("name", ["csr-closed1", "nrs-closed1"])
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 41])
def test_the_ports_plan_equals_the_reference_on_the_zipf_copy(name, seed):
    tr = traffic(name)
    cols = columns(seed)
    out = _port(tr, cols)
    got = {k: int(v) for k, v in exp1_plan.counters(out).items()}
    want = two_way.expect(cols, SMALL, tr)
    assert got == want
    numbers = two_way.judge(cols, dict(exp1_plan.rows(out), counters=got),
                            want, tr)
    assert set(numbers.values()) == {0}, numbers


def test_the_jax_package_gives_the_ports_counters_on_the_zipf_columns():
    import jax
    from hashjoin3d_tpu.models import exp1 as jexp1

    cols = columns(5)
    rk = cols["R"].numpy().view(np.uint32)
    sa = cols["S"].numpy().view(np.uint32)
    buf = io.StringIO()
    exp = jexp1.Experiment1(SMALL["log2_card_r"], SMALL["log2_card_s"],
                            True, 0, 1, measure_file=buf, min_runtime_s=0.0,
                            min_repeat=1, trace=False, backend="device",
                            plans=("Csr", "Nrs"), assert_route=None)
    exp._rk, exp._sa = jax.device_put(rk), jax.device_put(sa)
    exp.num_dv_sa = int(np.unique(sa).size)
    exp.run()
    lines = list(csv.reader(io.StringIO(buf.getvalue()), delimiter=";"))
    jax_rows = {r[9]: dict(zip(lines[0], r)) for r in lines[1:]}
    for plan, name in (("Csr", "csr-closed1"), ("Nrs", "nrs-closed1")):
        out = _port(traffic(name), cols)
        want = jax_rows[plan]
        assert int(out["c_htProbe"]) == int(want["c_htProbe"]), plan
        assert int(out["c_htProbeCmp"]) == int(want["c_htProbeCmp"]), plan
        assert int(out["total"]) == int(want["c_top"]), plan


def _skewed_stream():
    """A table of 2^16 words and 2^16 zipf keys over it, sorted in 2^14-key
    segments: a segment's sparse tail spreads a 1024-key chunk over more
    than a 1024-wide window."""
    cfg = dict(log2_card_r=16, log2_card_s=16, t=0)
    keys = exp1_zipf.columns(cfg, 11, CPU)["S"]
    keys = torch.sort(keys.view(-1, 1 << 14), dim=1).values.reshape(-1)
    g = torch.Generator().manual_seed(1)
    values = torch.randint(1, 1 << 30, (1 << 16,), generator=g,
                           dtype=torch.int32)
    return values, keys


def _uncovered(values, keys, W):
    return int(windowed_lookup_covered(
        torch.cat([values, values.new_zeros(W)]), keys, values.shape[0],
        W=W)[2])


def _lookup(values, keys, **kw):
    return _with_route(lambda: {"d": safe_lookup(values, keys, **kw)})()


@pytest.mark.parametrize("route", [1, 2])
def test_a_lookup_off_its_windows_tallies_and_times_its_regather(route):
    values, keys = _skewed_stream()
    nbad = _uncovered(values, keys, 1024)
    assert 1 < nbad < keys.numel() // 1024
    # the patch cap picks the route: every uncovered chunk, or fewer
    cap = nbad if route == 1 else 1
    out, recs, reads = profiled(
        lambda: _lookup(values, keys, W=1024, max_patch=cap))
    assert (int(out["route_worst"]), int(out["route_nbad"])) == (route, nbad)
    assert torch.equal(out["d"], values[keys.long()])
    (rec,) = recs
    assert rec.name == "hj.probe"
    assert rec.counts == {"lookup.uncovered": nbad}
    assert list(rec.timings) == ["lookup.regather"]
    assert len(rec.timings["lookup.regather"]) == 1
    assert rec.timed_ms("lookup.regather") is None  # no events on the CPU
    assert reads == {"lookup.route": 1}


def test_a_covered_lookup_tallies_nothing():
    """2^16 uniform keys over the same table, sorted: a chunk spreads over
    about 1024 words, inside a 4096-wide window."""
    values, _ = _skewed_stream()
    g = torch.Generator().manual_seed(2)
    keys = torch.sort(torch.randint(0, 1 << 16, (1 << 16,), generator=g,
                                    dtype=torch.int32)).values
    assert _uncovered(values, keys, 4096) == 0
    out, (rec,), reads = profiled(lambda: _lookup(values, keys, W=4096))
    assert int(out["route_worst"]) == 0
    assert torch.equal(out["d"], values[keys.long()])
    assert rec.counts == {} and rec.timings == {}
    assert rec.timed_ms("lookup.regather") == 0.0
    assert reads == {"lookup.route": 1}


def test_no_profiler_window_no_record():
    values, keys = _skewed_stream()
    tracing.clear()
    out = _lookup(values, keys, W=1024, max_patch=1)
    assert int(out["route_worst"]) == 2
    assert torch.equal(out["d"], values[keys.long()])
    assert tracing.timed("lookup.regather") is tracing._NOOP
    tracing.count("lookup.uncovered", 5)
    with tracing.timed("lookup.regather") as rec:
        assert rec is None
    assert tracing.records() == []
