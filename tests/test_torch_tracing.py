"""The port's program spans and host-read counters on the CPU.

* ``utils/tracing.py``: ``span`` makes no record outside a
  ``torch.profiler`` window and nests with the right parents inside one;
  ``host_read`` counts by site in the innermost open span, and nowhere
  outside one;
  ``trace``'s Chrome trace carries the ``hj.*`` names;
* the Csr, Nrs and Ndu paths (the benchmark's cells, at small sizes) open
  one ``hj.build`` root a table and one ``hj.probe`` root a strand, with
  the sub-spans where the work happens, and count their host reads by
  site (the Csr probe's and the Ndu query's pinned);
* ``partition_exchange`` and the distributed join's counter reduction on
  2 gloo ranks open the exchange spans.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hashjoin3d_tpu_torch.models.exp1 import Experiment1
from hashjoin3d_tpu_torch.models.exp4 import Experiment4
from hashjoin3d_tpu_torch.ops.chaining import can_use_dense_direct
from hashjoin3d_tpu_torch.utils import tracing
from hashjoin3d_tpu_torch.utils.tracing import host_read, span

from torch_ranks import RankPool

BUILD_SUBS = {"hj.build.hash", "hj.build.sort", "hj.build.runs",
              "hj.build.assemble"}


def profiled(fn):
    """``fn()`` in a CPU profiler window from a clean record list; its
    result, the records and the host reads they counted, by site.  Checks
    that no span with children runs an operator of its own."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = tracing.records()
    reads = {}
    for r in recs:
        for site, n in r.reads.items():
            reads[site] = reads.get(site, 0) + n
    tracing.clear()
    assert untiled(prof) == []
    return out, recs, reads


def untiled(prof) -> list:
    """``(span, operator)`` for each operator whose innermost span has
    child spans: work the children's boundary events would not time
    (``tracing.SpanRecord``)."""
    def span_of(e):
        e = e.cpu_parent
        while e is not None and not e.name.startswith("hj."):
            e = e.cpu_parent
        return e

    events = [e for e in prof.events() if e.device_type.name == "CPU"]
    parents = {id(span_of(e)) for e in events if e.name.startswith("hj.")}
    out = []
    for e in events:
        sp = span_of(e)
        if (e.name.startswith("aten::") and sp is not None
                and id(sp) in parents):
            out.append((sp.name, e.name))
    return out


def root_of(recs, rec):
    while rec.parent >= 0:
        rec = recs[rec.parent]
    return rec


def tree(recs) -> dict:
    """Root name -> the names of every span under its roots."""
    out = {}
    for r in recs:
        root = root_of(recs, r)
        subs = out.setdefault(root.name, set())
        if r is not root:
            subs.add(r.name)
    return out


def reads_by_root(recs) -> dict:
    """Root name -> site -> reads made under such roots."""
    out = {}
    for r in recs:
        dst = out.setdefault(root_of(recs, r).name, {})
        for site, n in r.reads.items():
            dst[site] = dst.get(site, 0) + n
    return out


def test_no_record_outside_a_profiler_window():
    tracing.clear()
    with span("hj.test") as rec:
        assert rec is None
        assert host_read(torch.tensor(7), "test.site") == 7
    assert tracing.records() == []


def test_spans_nest_with_their_parents_and_count_reads_inside_one():
    def body():
        with span("a"):
            with span("a.b"):
                assert host_read(torch.tensor([True]).all(), "s1") is True
                with span("a"):  # already open: opens nothing
                    host_read(torch.tensor(3), "s2")
            with span("a.c"):
                pass
        with span("d"):
            host_read(torch.tensor(1.5), "s1")
        assert host_read(torch.tensor(2), "s3") == 2  # no span open

    _, recs, reads = profiled(body)
    assert [(r.name, r.parent) for r in recs] == [
        ("a", -1), ("a.b", 0), ("a.c", 0), ("d", -1)]
    assert [r.index for r in recs] == [0, 1, 2, 3]
    assert recs[1].reads == {"s1": 1, "s2": 1}
    assert recs[0].reads == {} and recs[3].reads == {"s1": 1}
    assert reads == {"s1": 2, "s2": 1}
    for r in recs:
        assert r.t1_ns >= r.t0_ns and r.host_ms() >= 0
        assert r.device_ms() is None  # no CUDA events on the CPU
    assert recs[0].t0_ns <= recs[1].t0_ns <= recs[1].t1_ns <= recs[0].t1_ns


def test_one_event_marks_each_boundary(monkeypatch):
    made = []

    def event():
        made.append(object())
        return made[-1]

    monkeypatch.setattr(tracing, "_event", event)

    def body():
        with span("r"):
            with span("r.a"):
                pass
            with span("r.b"):
                pass
        with span("leaf"):
            pass

    _, (r, a, b, leaf), _ = profiled(body)
    # r's start, a's end, b's end; the leaf's two ends
    assert len(made) == 5
    assert a.ev0 is r.ev0 and b.ev0 is a.ev1 and r.ev1 is b.ev1
    assert len({id(r.ev0), id(a.ev1), id(b.ev1)}) == 3
    assert leaf.ev0 is made[3] and leaf.ev1 is made[4]


def test_a_parents_own_operator_is_found():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("hj.p"):
            with span("hj.p.a"):
                torch.arange(4).sum()
            torch.arange(4)  # between the children: no event times it
            with span("hj.p.b"):
                pass
    tracing.clear()
    assert ("hj.p", "aten::arange") in untiled(prof)


def test_the_record_list_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 2)

    def body():
        with span("a"):
            with span("b"):
                pass
            with span("c"):
                with span("c.d"):
                    pass

    _, recs, _ = profiled(body)
    assert [r.name for r in recs] == ["a", "b"]


def test_the_chrome_trace_carries_the_span_names(tmp_path):
    with tracing.trace(tmp_path / "prof"):
        with span("hj.probe"):
            with span("hj.probe.lookup"):
                torch.arange(8).sum()
    tracing.clear()
    names = {e.get("name") for e in json.loads(
        (tmp_path / "prof" / "trace.json").read_text())["traceEvents"]}
    assert {"hj.probe", "hj.probe.lookup"} <= names


def _exp1_plan(name):
    """Plan ``name`` of exp-1 at R10/S14 on the CPU, wired as the
    benchmark's entry wires it: R.k a permutation, S.a every key of
    [0, 2^10) once and the rest drawn."""
    g = torch.Generator().manual_seed(5)
    rk = torch.randperm(1 << 10, generator=g, dtype=torch.int32)
    sa = torch.cat([torch.arange(1 << 10, dtype=torch.int32),
                    torch.randint(0, 1 << 10, ((1 << 14) - (1 << 10),),
                                  generator=g, dtype=torch.int32)])
    sa = sa[torch.randperm(sa.shape[0], generator=g)]
    exp = Experiment1(10, 14, skew=False, t=0, b=1, device="cpu",
                      trace=False)
    exp.rk, exp.sa = rk, sa
    exp.num_dv_sa = int(torch.bincount(sa.long()).count_nonzero())
    exp.dense_direct_r = can_use_dense_direct(rk.numpy().view(np.uint32),
                                              exp.card_r)
    assert exp.dense_direct_r
    return exp.join_plan(name)


def _join(plan):
    table = plan.build(plan.build_keys)
    return plan.probe(table, plan.probe_keys)


def test_the_csr_path_opens_its_spans_and_pins_its_reads():
    plan = _exp1_plan("Csr")
    out, recs, reads = profiled(lambda: _join(plan))
    assert int(out["c_htProbe"]) == 1 << 14
    assert [r.name for r in recs if r.parent < 0] == ["hj.build", "hj.probe"]
    assert tree(recs) == {
        "hj.build": BUILD_SUBS,
        "hj.probe": {"hj.probe.sort", "hj.probe.lookup", "hj.probe.miss",
                     "hj.probe.emit"}}
    # the probe sort's two checks, the packed word's lookup, the miss test
    assert reads_by_root(recs) == {"hj.build": {}, "hj.probe": {
        "sort.presorted": 1, "sort.key_bits": 1, "lookup.route": 1,
        "miss.any": 1}}
    assert reads == reads_by_root(recs)["hj.probe"]
    by_name = {r.name: r for r in recs}
    assert by_name["hj.probe.sort"].reads == {"sort.presorted": 1,
                                              "sort.key_bits": 1}
    assert by_name["hj.probe.lookup"].reads == {"lookup.route": 1}
    assert by_name["hj.probe.miss"].reads == {"miss.any": 1}


def test_the_nrs_path_opens_its_spans_and_counts_its_reads():
    plan = _exp1_plan("Nrs")
    out, recs, reads = profiled(lambda: _join(plan))
    assert int(out["c_unnest"]) == 1 << 14
    assert [r.name for r in recs if r.parent < 0] == ["hj.build", "hj.probe"]
    assert tree(recs) == {
        "hj.build": BUILD_SUBS,
        "hj.probe": {"hj.probe.sort", "hj.probe.lookup", "hj.probe.miss",
                     "hj.probe.unnest", "hj.probe.emit"}}
    got = reads_by_root(recs)
    # the build's key sort checks its input once; the probe sorts nothing
    # (a permutation) and reads each lookup's route
    assert got["hj.build"] == {"sort.presorted": 1}
    assert set(got["hj.probe"]) == {"lookup.route", "miss.any"}
    assert got["hj.probe"]["miss.any"] == 1
    assert got["hj.probe"]["lookup.route"] >= 5
    assert sum(got["hj.probe"].values()) + 1 == sum(reads.values())


def test_the_ndu_path_opens_two_builds_and_one_probe():
    exp = Experiment4(12, 2, 2, 2, 2, device="cpu", trace=False)
    exp.init()

    def query():
        ts = exp.build("Ndu", exp.sa)
        tt = exp.build("Ndu", exp.ta)
        return exp.probe("Ndu", ts, tt, exp.rk)

    out, recs, reads = profiled(query)
    assert int(out["c_top"]) == exp.calc_join_card2()
    assert [r.name for r in recs if r.parent < 0] == [
        "hj.build", "hj.build", "hj.probe"]
    assert tree(recs) == {
        "hj.build": BUILD_SUBS,
        "hj.probe": {"hj.probe.lookup", "hj.probe.miss", "hj.probe.unnest",
                     "hj.probe.emit"}}
    unnests = [r for r in recs if r.name == "hj.probe.unnest"]
    assert len(unnests) == 2  # T's, then S's
    got = reads_by_root(recs)
    # each build: its key sort's check, and the directory's three fetches
    # by the windowed lookup (heads at most 8 rows apart)
    assert got["hj.build"] == {"sort.presorted": 2, "lookup.route": 6}
    # the probe: its lookups' routes and one miss test a join
    assert got["hj.probe"] == {"lookup.route": 20, "miss.any": 2}
    assert sum(reads.values()) == 30


def test_spans_change_no_result():
    plan = _exp1_plan("Nrs")
    plain = _join(plan)
    traced, _, _ = profiled(lambda: _join(plan))
    for k in ("probe_row", "build_row"):
        assert torch.equal(plain[k], traced[k])
    for k in ("c_htProbe", "c_htProbeCmp", "c_unnest"):
        assert int(plain[k]) == int(traced[k])


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield p
    p.close()


def test_the_exchange_opens_its_spans_on_two_gloo_ranks(pool):
    for res in pool.run("exchange_spans"):
        roots, tree_of, reduce_parents = res
        assert roots == ["hj.exchange", "hj.exchange", "hj.build",
                         "hj.exchange", "hj.probe", "hj.exchange.reduce"]
        assert tree_of["hj.exchange"] == {
            "hj.exchange.route", "hj.exchange.pack",
            "hj.exchange.all_to_all", "hj.exchange.reduce"}
        assert tree_of["hj.build"] == BUILD_SUBS
        assert "hj.probe.unnest" in tree_of["hj.probe"]
        # the first exchange reduces its overflow inside itself; the join
        # step's counter reduction stands alone
        assert reduce_parents == ["hj.exchange", None]
