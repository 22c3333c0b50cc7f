"""A configuration, a cell and a metric added as new files, and nothing
else (``t4crs``): the port's Crs on the CPU against the reference, the
control, and the benchmark's own tests run in a copy that holds them."""

import shutil
import subprocess
import sys

import pytest
import torch

from bench_cuda import control, harness, spec
from bench_cuda.harness import Context
from bench_cuda.recipes import instance_seed
from bench_cuda.references import two_way

from . import t4crs
from .conftest import small_copy

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 41])
def test_the_ports_crs_equals_the_reference_on_the_small_t4_copy(seed):
    from bench_cuda.entries import exp1_plan

    cfg = small_copy(t4crs.config(spec.ROOT))
    cols = spec.module("recipes", "exp1").columns(
        cfg, instance_seed(seed, 0), CPU)
    plan = exp1_plan.prepare(Context(cfg, t4crs.TRAFFIC, CPU), cols)
    out = exp1_plan.query(plan, lambda phase: None)
    got = {k: int(v) for k, v in exp1_plan.counters(out).items()}
    assert got == two_way.expect(cols, cfg, t4crs.TRAFFIC)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 77, 20261018])
def test_the_control_of_the_t4_crs_copy_comes_out_not_correct(seed):
    from .test_bench_reference import CONTROL_SIZES

    cfg = dict(t4crs.config(spec.ROOT), **CONTROL_SIZES["exp1"])
    cell = spec.Cell(name=t4crs.CELL, chips=1, config=cfg,
                     traffic=t4crs.TRAFFIC, end_to_end=[], per_layer=[])
    nums = control.control_numbers(cell, seed, CPU)
    assert any(nums[k] > v for k, v in two_way.LIMITS.items())


#: the cases of the benchmark's tests that the new cell gets, in the copy
NEW_CASES = [
    "test_bench_run.py::test_a_sound_run_is_correct[exp1-t4.crs]",
    *(f"test_bench_run.py::test_a_planted_fault_comes_out_not_correct"
      f"[exp1-t4.crs-{f}]" for f in ("_stale", "_half", "_altered")),
    "test_bench_program_trace.py::"
    "test_a_traced_cpu_run_reads_the_programs_counters[exp1-t4.crs]",
    *(f"test_bench_reference.py::test_control_comes_out_not_correct"
      f"[{s}-exp1-t4.crs]" for s in (1, 2 ** 31 + 77, 20261018)),
]


def test_new_files_alone_bring_the_t4_crs_cell(tmp_path):
    """The copy's own tests of its contract, and every case the new cell
    gets: a sound CPU run reads correct with every limit at 0, each
    planted fault and the control read not correct."""
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "bench_cuda").rglob("*") if p.is_file()}
    t4crs.add_to(tmp_path)
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "bench_cuda").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    assert len(after) == len(before) + 3
    old = spec.load_benchmark()
    new = spec.load_benchmark(tmp_path / "BENCHMARK.json")
    for key, value in old.items():
        if isinstance(value, list):
            assert new[key][:len(value)] == value
        else:
            assert new[key] == value
    assert set(harness.limits(two_way).values()) == {0}
    (tmp_path / "hashjoin3d_tpu_torch").symlink_to(
        spec.ROOT / "hashjoin3d_tpu_torch")
    tests = tmp_path / "bench_cuda" / "tests"
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p",
         "no:cacheprovider", "-p", "no:randomly", "-k",
         f"{t4crs.CELL} or test_bench_spec",
         *(str(tests / f) for f in ("test_bench_spec.py",
                                    "test_bench_run.py",
                                    "test_bench_program_trace.py",
                                    "test_bench_reference.py"))],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    passed = {line.split(" ", 1)[1].split("bench_cuda/tests/", 1)[1]
              for line in r.stdout.splitlines()
              if line.startswith("PASSED ")}
    assert set(NEW_CASES) <= passed
    assert any(p.startswith("test_bench_spec.py::") for p in passed)
