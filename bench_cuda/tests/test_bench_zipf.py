"""The zipf configuration's cell and the two readers of the windowed
lookups' re-gathers: the readers on synthetic records, divided by the
probe roots, None where the run or the program holds nothing to read; the
control of the zipf cell, which has to come out not correct; and a traced
CPU run of the zipf cell, where the program's records are real."""

import time

import pytest
import torch

from bench_cuda import control, harness, program_trace, spec
from bench_cuda.references import two_way

from .test_bench_program_trace import _run, read
from .test_bench_reference import CONTROL_SIZES

CPU = torch.device("cpu")
CELLS = ("exp1-zipf.nrs",)
METRICS = ("lookup_uncovered_chunks", "lookup_regather_ms")


class Rec:
    """A span record with tallies and timed sites (``ms``: the device ms
    of each ``lookup.regather`` pair, None for a pair without events)."""

    def __init__(self, name, parent=-1, counts=None, ms=(), t0_ns=None):
        self.name, self.parent = name, parent
        self.counts = counts or {}
        self.ms = list(ms)
        self.reads = {}
        self.t0_ns = self.t1_ns = t0_ns

    def timed_ms(self, site):
        if site != "lookup.regather":
            return 0.0
        if any(m is None for m in self.ms):
            return None
        return sum(self.ms)


def _records(pair_ms=2.0):
    """A warm-up query long before the traced window, then two queries:
    the first re-gathers in its probe's lookup (3 chunks, twice) and in
    its build (1 chunk), the second keeps its windows; an exchange root
    whose tally no query reads."""
    recs = []

    def add(name, parent=-1, counts=None, ms=(), t0_ns=None):
        t = 10 ** 12 + len(recs) * 1000 if t0_ns is None else t0_ns
        recs.append(Rec(name, parent, counts, ms, t))
        return len(recs) - 1

    p = add("hj.probe", t0_ns=0)
    add("hj.probe.lookup", p, {"lookup.uncovered": 99}, (50.0,), t0_ns=1)
    for q in range(2):
        x = add("hj.exchange")
        add("hj.exchange.route", x, {"lookup.uncovered": 7}, (9.0,))
        b = add("hj.build")
        add("hj.build.runs", b, {"lookup.uncovered": 1} if q == 0 else {},
            (0.5,) if q == 0 else ())
        p = add("hj.probe")
        add("hj.probe.sort", p)
        add("hj.probe.lookup", p,
            {"lookup.uncovered": 3} if q == 0 else {}, (pair_ms, pair_ms) if q == 0 else ())
    return recs


def test_the_readers_divide_by_the_probe_roots(monkeypatch):
    monkeypatch.setattr(program_trace, "records", _records)
    run = _run()
    assert read("lookup_uncovered_chunks", run) == pytest.approx(2.0)
    assert read("lookup_regather_ms", run) == pytest.approx(2.25)
    # a window in which no lookup re-gathers reads 0, not nothing
    monkeypatch.setattr(program_trace, "records",
                        lambda: [Rec("hj.probe", t0_ns=1)])
    assert read("lookup_uncovered_chunks", run) == 0
    assert read("lookup_regather_ms", run) == 0.0


def test_the_readers_return_none_with_nothing_to_read(monkeypatch):
    monkeypatch.setattr(program_trace, "records", _records)
    for name in METRICS:
        assert read(name, _run(trace=False)) is None
    for recs in (None, []):
        monkeypatch.setattr(program_trace, "records", lambda r=recs: r)
        for name in METRICS:
            assert read(name, _run()) is None
    # a program whose records keep no tallies and no timed sites
    from .test_bench_program_trace import Rec as PlainRec

    monkeypatch.setattr(program_trace, "records",
                        lambda: [PlainRec("hj.probe", ms=1.0)])
    for name in METRICS:
        assert read(name, _run()) is None
    # pairs without device events (the CPU)
    monkeypatch.setattr(program_trace, "records",
                        lambda: _records(pair_ms=None))
    assert read("lookup_regather_ms", _run()) is None
    assert read("lookup_uncovered_chunks", _run()) == pytest.approx(2.0)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 77, 20261018])
def test_the_zipf_control_comes_out_not_correct(cell, seed):
    c = spec.load_cell(cell)
    c.config = dict(c.config, **CONTROL_SIZES["exp1"])
    nums = control.control_numbers(c, seed, CPU)
    assert any(nums[k] > v for k, v in two_way.LIMITS.items())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_of_a_zipf_cell_reads_both_metrics(
        small_bench, quick, monkeypatch, cell):
    from hashjoin3d_tpu_torch.utils import tracing

    tracing.clear()
    c = spec.load_cell(cell, small_bench)
    assert [m["name"] for m in c.per_layer] == list(METRICS)
    run, checks, attempted, failed = harness.run(
        c, 2 ** 31 + 19, 0.6, True, CPU, time.perf_counter())
    recs = tracing.records()
    tracing.clear()
    monkeypatch.setattr(program_trace, "records", lambda: recs)
    assert all(v == 0 for v in checks.values()), checks
    # the small copy's windows cover its streams: nothing re-gathered
    assert failed == 0
    assert read("lookup_uncovered_chunks", run) == 0
    assert read("lookup_regather_ms", run) == 0.0
