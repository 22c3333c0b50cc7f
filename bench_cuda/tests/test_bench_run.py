"""Runs of the harness on the CPU at small sizes (the kernels' plain
versions), with the timed path sound and with each fault a cell can have
planted underneath; the command without a card; the import check."""

import json
import subprocess
import sys
import time

import pytest
import torch

from bench_cuda import harness, ranks, spec
from bench_cuda.run import forbidden_modules, result_line

from . import rankfaults
from .conftest import one_card_cells

CPU = torch.device("cpu")
SINGLE = one_card_cells()


def _line(cell, res, trace=False):
    run, checks, attempted, failed = res
    limits = harness.limits(spec.module("references",
                                        cell.traffic["reference"]))
    return result_line(cell, run, checks, limits, attempted, failed, trace,
                       "cpu")


def _run(bench, name, seconds=0.6, trace=False, seed=2 ** 31 + 11):
    cell = spec.load_cell(name, bench)
    return cell, harness.run(cell, seed, seconds, trace, CPU,
                             time.perf_counter())


@pytest.mark.parametrize("name", SINGLE)
def test_a_sound_run_is_correct(small_bench, quick, name):
    cell, res = _run(small_bench, name)
    line = _line(cell, res)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 4 and line["failed"] == 0
    assert set(line["metrics"]) == {"rows_per_s", "query_ms_p95",
                                    "setup_s"}
    assert list(line)[-1] == "checks"


def test_a_traced_run_reports_the_per_layer_line(small_bench, quick):
    cell, res = _run(small_bench, "exp1-t0.csr", trace=True)
    line = _line(cell, res, trace=True)
    assert line["correct"]
    assert "breakdown" in line and "window_s" in line["device"]
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}


def _stale(entry, monkeypatch):
    """Every query answers with the first query's result."""
    orig, first = entry.query, []

    def query(state, mark):
        out = orig(state, mark)
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(entry, "query", query)


def _half(entry, monkeypatch):
    """Half of each probe column left out."""
    orig = entry.prepare

    def prepare(ctx, cols):
        probe = ctx.traffic.get("table", {}).get("probe", "R")
        cols = dict(cols)
        cols[probe] = cols[probe][:cols[probe].shape[0] // 2]
        return orig(ctx, cols)

    monkeypatch.setattr(entry, "prepare", prepare)


def _altered(entry, monkeypatch):
    """One result row altered where the strand produces it."""
    orig = entry.query

    def query(state, mark):
        out = dict(orig(state, mark))
        key = next(iter(entry.rows(out)))
        col = out[key].clone()
        col[0] = (col[0] + 1) % col.shape[0]
        out[key] = col
        return out

    monkeypatch.setattr(entry, "query", query)


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("name", SINGLE)
def test_a_planted_fault_comes_out_not_correct(small_bench, quick,
                                               monkeypatch, name, fault):
    cell = spec.load_cell(name, small_bench)
    fault(spec.module("entries", cell.traffic["entry"]), monkeypatch)
    _, res = _run(small_bench, name)
    assert not _line(cell, res)["correct"]


def _dist(bench, worker, trace=False):
    cell = spec.load_cell("exp1-dist4.nrs", bench)
    return cell, ranks.launch(bench, cell, 2 ** 31 + 5, 2.0, trace, "cpu",
                              time.perf_counter(), worker=worker)


def test_the_distributed_cell_on_four_gloo_ranks(small_bench, quick):
    cell, res = _dist(small_bench, rankfaults.worker)
    line = _line(cell, res)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4


@pytest.mark.parametrize("fault", ["no_exchange", "half"])
def test_the_distributed_cell_catches_its_faults(small_bench, quick,
                                                 monkeypatch, fault):
    from bench_cuda.entries import dist_nested
    from hashjoin3d_tpu_torch.parallel import shuffle

    if fault == "no_exchange":
        monkeypatch.setattr(shuffle, "all_to_all", rankfaults.no_all_to_all)
        worker = rankfaults.worker_no_exchange
    else:
        monkeypatch.setattr(dist_nested, "prepare",
                            rankfaults.half_probe_prepare)
        worker = rankfaults.worker_half
    cell, res = _dist(small_bench, worker)
    assert not _line(cell, res)["correct"]


def test_without_a_card_the_command_exits_nonzero(no_card_env):
    r = subprocess.run([sys.executable, "bench_cuda/run.py", "--workload",
                        "exp1-t0.csr", "--seed", str(2 ** 31 + 1),
                        "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, env=no_card_env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_forbidden_modules_compare_top_level_names_whole():
    assert forbidden_modules(["hashjoin3d_tpu_torch", "numpy",
                              "hashjoin3d_tpu_torch.ops.layout",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["hashjoin3d_tpu.ops", "jax.numpy", "jaxlib",
                              "flax.linen"]) == ["flax", "hashjoin3d_tpu",
                                                 "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package(small_bench):
    code = ("import sys, time, torch; sys.path.insert(0, '.');"
            "from bench_cuda import harness, spec;"
            "from bench_cuda.run import forbidden_modules;"
            f"cell = spec.load_cell('exp1-t0.nrs', {str(small_bench)!r});"
            "harness.run(cell, 1, 0.3, False, torch.device('cpu'),"
            " time.perf_counter());"
            "print(forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_the_cells_are_correct_on_the_card(card):
    for name in SINGLE:
        r = subprocess.run([sys.executable, "bench_cuda/run.py",
                            "--workload", name, "--seed", "20261018",
                            "--seconds", "2", "--trace", "0"],
                           cwd=spec.ROOT, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        assert json.loads(r.stdout.splitlines()[-1])["correct"]


def test_the_traced_span_leaves_the_profilers_close_out(small_bench, quick,
                                                       monkeypatch):
    """The traced window ends before the profiler closes, whose own work
    is no idle time of the card."""
    import torch.profiler

    slow = 0.5
    orig = torch.profiler.profile.__exit__

    def exit_slowly(self, *exc):
        time.sleep(slow)
        return orig(self, *exc)

    monkeypatch.setattr(torch.profiler.profile, "__exit__", exit_slowly)
    cell, res = _run(small_bench, "exp1-t0.nrs", trace=True)
    run = res[0]
    assert run.trace.queries == 2
    assert run.trace.window_s < slow
