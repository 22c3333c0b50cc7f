"""The readers of the program's own spans and host-read counters:
synthetic records and span-named idle gaps, divided by the probe roots,
None where the run or the program holds nothing to read; and a traced
CPU run of the harness, where the program's records are real."""

import time

import pytest
import torch

from bench_cuda import harness, measure, program_trace, spec
from bench_cuda.harness import Run

from .conftest import one_card_cells

SPAN_METRICS = ("build_hash_ms", "build_sort_ms", "build_runs_ms",
                "probe_sort_ms", "probe_lookup_ms", "probe_miss_ms",
                "probe_unnest_ms", "exchange_ms")
GLUE_METRICS = ("build_glue_idle_ms", "probe_glue_idle_ms")
ALL = SPAN_METRICS + GLUE_METRICS + ("program_host_reads",)


class Rec:
    def __init__(self, name, parent=-1, ms=None, reads=None, t0_ns=10 ** 12):
        self.name, self.parent, self.ms = name, parent, ms
        self.reads = reads or {}
        self.t0_ns = self.t1_ns = t0_ns

    def device_ms(self):
        return self.ms


def _records():
    """A warm-up query long before the traced window, then the window's two
    queries of one build and one probe, a dist-like exchange and reduce in
    the first; device ms per span."""
    recs = []

    def add(name, parent=-1, ms=None, reads=None, t0_ns=None):
        t = 10 ** 12 + len(recs) * 1000 if t0_ns is None else t0_ns
        recs.append(Rec(name, parent, ms, reads, t))
        return len(recs) - 1

    # the warm-up: outside the window, so none of it counts
    w = add("hj.build", ms=1e6, t0_ns=0)
    add("hj.build.hash", w, 1e6, {"sort.presorted": 99}, t0_ns=1)
    add("hj.probe", ms=1e6, t0_ns=2)
    add("hj.exchange.reduce", ms=1e6, t0_ns=3)
    for q in range(2):
        if q == 0:
            x = add("hj.exchange", ms=5.0)
            add("hj.exchange.route", x, 1.0)
            add("hj.exchange.reduce", x, 0.5)  # inside: counted in 5.0
        b = add("hj.build", ms=10.0)
        add("hj.build.hash", b, 1.0)
        add("hj.build.sort", b, 4.0, {"sort.presorted": 1})
        add("hj.build.runs", b, 2.0, {"lookup.route": 3})
        p = add("hj.probe", ms=8.0)
        add("hj.probe.sort", p, 3.0, {"sort.presorted": 1,
                                      "sort.key_bits": 1})
        add("hj.probe.lookup", p, 2.0, {"lookup.route": 1})
        add("hj.probe.miss", p, 0.75, {"miss.any": 1})
        add("hj.probe.unnest", p, 1.5, {"lookup.route": 4})
        add("hj.probe.unnest", p, 0.5)
        if q == 0:
            add("hj.exchange.reduce", ms=0.25)  # the counters', alone
    return recs


def _run(trace=True, gaps=None):
    tr = measure.Trace(queries=4, window_s=0.1, busy_s=0.05,
                       idle_gaps=gaps or {}) if trace else None
    return Run(config={"rows": {"R": 10}}, traffic={"rows": ["R"]},
               world=1, queries=10, window_s=1.0, setup_s=1.0,
               latencies_s=[0.01], peak_bytes=1, trace=tr)


def read(name, run):
    return spec.module("metrics", name).read(run)


def test_span_readers_divide_by_the_probe_roots(monkeypatch):
    monkeypatch.setattr(program_trace, "records", _records)
    run = _run()
    assert read("build_hash_ms", run) == pytest.approx(1.0)
    assert read("build_sort_ms", run) == pytest.approx(4.0)
    assert read("build_runs_ms", run) == pytest.approx(2.0)
    assert read("probe_sort_ms", run) == pytest.approx(3.0)
    assert read("probe_lookup_ms", run) == pytest.approx(2.0)
    assert read("probe_miss_ms", run) == pytest.approx(0.75)
    assert read("probe_unnest_ms", run) == pytest.approx(2.0)
    # the exchange root, and the reduce outside any exchange
    assert read("exchange_ms", run) == pytest.approx((5.0 + 0.25) / 2)
    # build reads 1 + 3, probe reads 1 + 1 + 1 + 1 + 4, a query
    assert read("program_host_reads", run) == pytest.approx(12.0)


def test_glue_readers_take_span_named_gaps_over_the_traced_queries(
        monkeypatch):
    monkeypatch.setattr(program_trace, "records", _records)
    run = _run(gaps={"hj.build": 0.001, "hj.build.sort": 0.003,
                     "hj.buildings": 1.0, "hj.probe.unnest": 0.002,
                     "(between host calls)": 0.5, "aten::where": 0.25})
    assert read("build_glue_idle_ms", run) == pytest.approx(1.0)
    assert read("probe_glue_idle_ms", run) == pytest.approx(0.5)
    # spans but no gap under them: no idle time, not an absent metric
    assert read("build_glue_idle_ms", _run()) == 0.0


def test_readers_return_none_with_nothing_to_read(monkeypatch):
    monkeypatch.setattr(program_trace, "records", _records)
    for name in ALL:
        assert read(name, _run(trace=False)) is None
    # a program that keeps no records, or an empty list
    for recs in (None, []):
        monkeypatch.setattr(program_trace, "records", lambda r=recs: r)
        for name in ALL:
            assert read(name, _run(gaps={"hj.build": 1.0})) is None
    # records without the span, or without a probe root
    monkeypatch.setattr(program_trace, "records",
                        lambda: [Rec("hj.probe", ms=1.0)])
    for name in ("build_hash_ms", "build_runs_ms", "exchange_ms",
                 "probe_miss_ms", "probe_unnest_ms", "build_glue_idle_ms"):
        assert read(name, _run()) is None
    monkeypatch.setattr(program_trace, "records",
                        lambda: [Rec("hj.build", ms=1.0),
                                 Rec("hj.build.hash", 0, 1.0)])
    assert read("build_hash_ms", _run()) is None
    # spans without device events (the CPU)
    monkeypatch.setattr(program_trace, "records",
                        lambda: [Rec("hj.probe"), Rec("hj.probe.sort", 0)])
    assert read("probe_sort_ms", _run()) is None


def test_a_program_without_the_surface_reads_nothing(monkeypatch):
    from hashjoin3d_tpu_torch.utils import tracing

    assert isinstance(program_trace.records(), list)
    monkeypatch.delattr(tracing, "records")
    assert program_trace.records() is None
    for name in ALL:
        assert read(name, _run(gaps={"hj.build": 1.0})) is None


@pytest.mark.parametrize("name", one_card_cells())
def test_a_traced_cpu_run_reads_the_programs_counters(small_bench, quick,
                                                      monkeypatch, name):
    from hashjoin3d_tpu_torch.utils import tracing

    tracing.clear()
    cell = spec.load_cell(name, small_bench)
    run = harness.run(cell, 2 ** 31 + 17, 0.6, True, torch.device("cpu"),
                      time.perf_counter())[0]
    recs = tracing.records()
    tracing.clear()
    monkeypatch.setattr(program_trace, "records", lambda: recs)
    probes = [r for r in recs if r.name == "hj.probe"]
    # the profiled warm-up query and the traced span
    assert len(probes) == harness.TRACE_QUERIES + 1
    assert {r.name for r in recs if r.parent < 0} == {"hj.build",
                                                       "hj.probe"}
    # every query reads as often as the warm-up, which the window leaves
    # out
    reads = read("program_host_reads", run)
    assert reads == sum(sum(r.reads.values()) for r in recs) / len(probes)
    assert reads >= 1
    # no device events and no device gaps on the CPU
    for m in SPAN_METRICS:
        assert read(m, run) is None
    for m in GLUE_METRICS:
        assert read(m, run) == 0.0
