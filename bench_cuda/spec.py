"""Find a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
the configuration file it names, the traffic mix
``workloads/<traffic>.json``, and the modules of ``recipes/``,
``entries/``, ``references/`` and ``metrics/`` that the files name.

Nothing here knows a cell, a configuration or a metric: a later cell adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    """One ``workloads`` entry of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict      #: the configuration file's contents
    traffic: dict     #: the traffic mix file's contents
    end_to_end: list  #: the end-to-end metrics this cell reports
    per_layer: list   #: the per-layer metrics this cell reports


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, path: Path = BENCHMARK) -> Cell:
    """The cell ``name`` of the benchmark file at ``path``; raises
    ``KeyError`` for a name it does not list."""
    bench = load_benchmark(path)
    root = Path(path).resolve().parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {path} "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "workloads" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def module(kind: str, name: str):
    """``bench_cuda.<kind>.<name>``, a module named by a data file (``-``
    and ``.`` in the name read as ``_``)."""
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"bench_cuda.{kind}.{mod}")
