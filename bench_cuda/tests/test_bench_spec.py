"""``BENCHMARK.json`` against the contract's shape, and a configuration,
a cell and a metric added as new files being found without an edit."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from bench_cuda import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.load_benchmark()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_cuda/run.py"]
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    items = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for kind in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for x in items:
        assert NAME.match(x["name"]), x["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_the_contract_asks():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for name in cells:
        cell = spec.load_cell(name)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)


def test_every_named_file_and_module_exists():
    used = set()
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        used.add(w["config"])
        for kind, key in (("recipes", cell.config["recipe"]),
                          ("entries", cell.traffic["entry"]),
                          ("references", cell.traffic["reference"])):
            assert spec.module(kind, key)
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)


def test_configs_files_agree_with_the_benchmark():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg.get("assumed", {}))


NEW_METRIC = '''"""Queries completed in the window."""


def read(run):
    return float(run.queries)
'''

DRIVE = '''
import json, sys, time
import torch
from bench_cuda import harness, spec
from bench_cuda.run import result_line
harness.SAMPLE_ROUNDS = 1
cell = spec.load_cell("exp1-small.csr2")
res = harness.run(cell, 2 ** 31 + 3, 1.0, False, torch.device("cpu"),
                  time.perf_counter())
run, checks, attempted, failed = res
limits = harness.limits(spec.module("references",
                                    cell.traffic["reference"]))
print(json.dumps(result_line(cell, run, checks, limits, attempted, failed,
                             False, "cpu")))
'''


def test_new_config_cell_and_metric_are_found_without_edits(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "bench_cuda").rglob("*") if p.is_file()}
    b = tmp_path / "bench_cuda"
    cfg = json.loads((b / "configs" / "exp1-R20S24-t0.json").read_text())
    cfg.update(name="exp1-small", log2_card_r=10, log2_card_s=14,
               rows={"R": 1024, "S": 16384})
    (b / "configs" / "exp1-small.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "workloads" / "csr-closed1.json").read_text())
    traffic["instances"] = 2
    (b / "workloads" / "csr-closed2.json").write_text(json.dumps(traffic))
    (b / "metrics" / "queries_in_window.py").write_text(NEW_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="exp1-small", source=cfg["source"],
                                 file="bench_cuda/configs/exp1-small.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="exp1-small.csr2",
                                   config="exp1-small",
                                   traffic="csr-closed2", chips=1,
                                   why="a test"))
    bench["end_to_end"].append(dict(name="queries_in_window",
                                    unit="count", better="higher",
                                    bound=0.1, source="host_clock",
                                    workloads=["exp1-small.csr2"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    # the program is found beside the benchmark, as in a checkout
    (tmp_path / "hashjoin3d_tpu_torch").symlink_to(
        spec.ROOT / "hashjoin3d_tpu_torch")
    r = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["queries_in_window"]["value"] >= 2
    assert "rows_per_s" in line["metrics"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "bench_cuda").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)


def test_the_benchmark_alone_cannot_run(tmp_path):
    """Without the program beside it the entries cannot load."""
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.remove(sys.path[0]); sys.path.insert(0,"
            " '.'); from bench_cuda import spec; "
            "spec.module('entries', 'exp1_plan')")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "hashjoin3d_tpu_torch" in r.stderr


def test_paths_hold_only_the_benchmark():
    root = spec.ROOT / BENCH["paths"][0]
    assert root == spec.HERE
    assert not (spec.HERE / "BENCHMARK.json").exists()
    assert Path(BENCH["command"][1]).parts[0] == BENCH["paths"][0]
