"""Small copies of the cells, and the card fixture."""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest
import torch

from bench_cuda import harness, spec


def one_card_cells() -> list:
    """The names of ``BENCHMARK.json``'s one-card cells, in its order."""
    return [w["name"] for w in spec.load_benchmark()["workloads"]
            if w["chips"] == 1]


def small_copy(config: dict) -> dict:
    """``config`` as its recipe cuts it for a CPU run (the plain versions
    of the kernels run there)."""
    return dict(config, **spec.module("recipes", config["recipe"]).small(
        config))


#: the 4-card cell waits outside ``BENCHMARK.json`` for its measurements
#: (PERF.md §7); its files are in place, and the tests add it
DIST_CONFIG = "bench_cuda/configs/exp1-R22S26-t0-4ranks.json"
DIST_CELL = {"name": "exp1-dist4.nrs", "config": "exp1-R22S26-t0-4ranks",
             "traffic": "nrs-dist-closed1", "chips": 4, "why": "tests"}
DIST_METRIC = {"name": "collective_ms", "unit": "ms", "better": "lower",
               "source": "device_trace", "layer": "distributed exchange",
               "moves": "rows_per_s", "workloads": ["exp1-dist4.nrs"]}


def with_dist(bench: dict) -> dict:
    """``bench`` with the 4-card cell, its configuration and metric."""
    if any(w["name"] == DIST_CELL["name"] for w in bench["workloads"]):
        return bench
    cfg = json.loads((spec.ROOT / DIST_CONFIG).read_text())
    bench["configs"].append(dict(name=cfg["name"], source=cfg["source"],
                                 file=DIST_CONFIG, reduced=cfg["reduced"],
                                 why="tests"))
    bench["workloads"].append(dict(DIST_CELL))
    bench["per_layer"].append(dict(DIST_METRIC))
    return bench


def write_small_bench(root: Path, small: bool = True) -> Path:
    """A ``BENCHMARK.json`` in ``root`` with the 4-card cell, whose
    configurations are small copies of the real ones (``small``) or the
    real ones (the traffic mixes and code are the real ones); returns its
    path."""
    bench = with_dist(spec.load_benchmark())
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        if small:
            cfg = small_copy(cfg)
        c["file"] = f"{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def small_bench(tmp_path):
    return write_small_bench(tmp_path)


@pytest.fixture
def quick(monkeypatch):
    """Judge the first round's queries and trace two queries from the
    fourth, so that a short CPU window reaches them."""
    monkeypatch.setattr(harness, "SAMPLE_ROUNDS", 1)
    monkeypatch.setattr(harness, "TRACE_FROM", 4)
    monkeypatch.setattr(harness, "TRACE_QUERIES", 2)


@pytest.fixture
def card():
    """A CUDA card, or the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("BENCH_RUN", None)
    return env
