"""The port's Crs at heavy duplication on the CPU, against the benchmark's
plain reference.

exp-1 at ``-t 2`` and ``-t 4`` (64 and 256 S rows a key, most R probes
missing), cut to R 2^10 / S 2^14: the columns are the benchmark's recipe
(``bench_cuda/recipes/exp1.py``), the plan is ``models/exp1.py``'s
``Crs`` (a compacted chaining table on S without the early-exit index,
probed by the R permutation, every probe walking its whole chain), and the
reference is ``bench_cuda/references/two_way.py`` (plain torch).  The
counters equal the reference's exactly, and the pairs pass its checks at
limit 0.  A traced query opens the whole-chain walk's own span,
``hj.probe.walk``, and no ``hj.probe.miss``; its ``hj.probe.sort`` is
the permutation's inverse (no sort).
"""

import json

import numpy as np
import pytest
import torch

from bench_cuda import spec
from bench_cuda.recipes import exp1 as recipe
from bench_cuda.recipes import instance_seed
from bench_cuda.references import two_way
from hashjoin3d_tpu_torch.models.exp1 import Experiment1
from hashjoin3d_tpu_torch.ops.chaining import can_use_dense_direct

from test_torch_tracing import BUILD_SUBS, profiled, reads_by_root, tree

TRAFFIC = json.loads(
    (spec.HERE / "workloads" / "crs-closed1.json").read_text())


def _config(t: int) -> dict:
    cfg = json.loads(
        (spec.ROOT / "bench_cuda/configs/exp1-R20S24-t4.json").read_text())
    cfg["t"] = t
    return dict(cfg, **recipe.small(cfg))


def _crs(cfg: dict, seed: int):
    """The recipe's columns of ``seed`` and the port's Crs plan over them,
    wired as ``Experiment1.init()`` wires its own columns."""
    cols = recipe.columns(cfg, instance_seed(seed, 0), torch.device("cpu"))
    exp = Experiment1(cfg["log2_card_r"], cfg["log2_card_s"], skew=False,
                      t=cfg["t"], b=cfg["b"], device="cpu", trace=False)
    exp.rk, exp.sa = cols["R"], cols["S"]
    exp.num_dv_sa = int(torch.bincount(cols["S"].long()).count_nonzero())
    exp.dense_direct_r = can_use_dense_direct(
        cols["R"].numpy().view(np.uint32), exp.card_r)
    assert exp.dense_direct_r
    return cols, exp.join_plan("Crs")


#: host reads of a Crs query: the build's key sort checks its input once;
#: the probe reads each windowed lookup's route (two in the lookup, four in
#: the unnest); the walk's one-pass sum reads nothing
PINNED_READS = {"hj.build": {"sort.presorted": 1},
                "hj.probe": {"lookup.route": 6}}


def _join(plan):
    return plan.probe(plan.build(plan.build_keys), plan.probe_keys)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 41])
@pytest.mark.parametrize("t", [2, 4])
def test_crs_equals_the_reference_at_heavy_duplication(t, seed):
    cfg = _config(t)
    cols, plan = _crs(cfg, seed)
    out = _join(plan)
    got = {"matches": int(out["c_htProbe"]),
           "cmps": int(out["c_htProbeCmp"]),
           "total": int(out["total"])}
    expected = two_way.expect(cols, cfg, TRAFFIC)
    assert got == expected
    # every S row joins its key's one R row
    assert expected["total"] == 1 << cfg["log2_card_s"]
    numbers = two_way.judge(
        cols, {"probe_row": out["probe_row"], "build_row": out["build_row"],
               "counters": got}, expected, TRAFFIC)
    assert numbers == {k: 0 for k in two_way.LIMITS}


def test_a_traced_crs_query_opens_the_walk_span_and_pins_its_reads():
    cfg = _config(4)
    _, plan = _crs(cfg, 7)
    out, recs, reads = profiled(lambda: _join(plan))
    assert int(out["total"]) == 1 << cfg["log2_card_s"]
    assert [r.name for r in recs if r.parent < 0] == ["hj.build", "hj.probe"]
    assert tree(recs) == {
        "hj.build": BUILD_SUBS,
        "hj.probe": {"hj.probe.sort", "hj.probe.lookup", "hj.probe.walk",
                     "hj.probe.unnest", "hj.probe.emit"}}
    walks = [r for r in recs if r.name == "hj.probe.walk"]
    assert len(walks) == 1 and recs[walks[0].parent].name == "hj.probe"
    assert reads_by_root(recs) == PINNED_READS
    assert walks[0].reads == {}
    assert reads == {"sort.presorted": 1, "lookup.route": 6}
