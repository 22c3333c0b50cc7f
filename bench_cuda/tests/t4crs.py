"""A configuration, a cell and a metric that a later change adds as new
files: exp-1 at ``-t 4`` (256 build rows a key, 15 of 16 probes miss) and
its plan Crs, a chaining table on S probed by R without early exit.

:func:`add_to` writes them into a copy of the benchmark and appends their
entries to its ``BENCHMARK.json``; it edits no file the copy has."""

from __future__ import annotations

import json
from pathlib import Path

CONFIG_NAME = "exp1-R20S24-t4"
CELL = "exp1-t4.crs"
SOURCE = ("https://github.com/dflaxx/3d-hashjoin main_experiment1 -R 20 "
          "-S 24 --no-skew -t 4 -b 1 (CIDR 2022, The 3D Hash Join)")

TRAFFIC = {
    "why": "exp-1 plan Crs: compacted chaining build of S with its bucket "
           "directory, key-direct probe of the R permutation, every probe "
           "walks its whole chain (no early exit)",
    "loop": "closed",
    "clients": 1,
    "instances": 4,
    "entry": "exp1_plan",
    "plan": "Crs",
    "reference": "two_way",
    "table": {"kind": "chaining", "build": "S", "probe": "R",
              "early_exit": False, "buckets": "build_distinct"},
    "rows": ["R", "S"],
}

METRIC = "probe_chain_walk_ms"
READER = '''\
"""Stream ms a query of the program's ``hj.probe.miss`` spans in a
probe without early exit: every probe's whole-chain walk
(``_full_chain_cmps``)."""

from ..program_trace import span_ms


def read(run):
    return span_ms(run, ("hj.probe.miss",))
'''


def config(root: Path) -> dict:
    """The ``-t 4`` configuration: the ``-t 0`` one of the benchmark at
    ``root`` with the source's ``-t`` and the deployment it gives."""
    cfg = json.loads(
        (root / "bench_cuda/configs/exp1-R20S24-t0.json").read_text())
    cfg.update(name=CONFIG_NAME, source=SOURCE, t=4, deployment=(
        "exp-1's heavy-duplicate join on one card: R.k a permutation of "
        "2^20 keys, S.a 2^24 foreign keys uniform over [0, 2^16), 256 "
        "rows a key, 1 bucket a distinct S key"))
    return cfg


def add_to(root: Path) -> None:
    """Add the configuration, the traffic mix ``crs-closed1`` and the
    metric's reader under ``root/bench_cuda``, and their entries at the
    end of ``root/BENCHMARK.json``'s lists."""
    b = root / "bench_cuda"
    (b / "configs" / f"{CONFIG_NAME}.json").write_text(
        json.dumps(config(root), indent=2) + "\n")
    (b / "workloads" / "crs-closed1.json").write_text(
        json.dumps(TRAFFIC, indent=2) + "\n")
    (b / "metrics" / f"{METRIC}.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name=CONFIG_NAME, source=SOURCE,
        file=f"bench_cuda/configs/{CONFIG_NAME}.json", reduced=[],
        why="exp-1's heavy-duplicate setting at the source's own scale: "
            "256 build rows a key, 15 of 16 probes miss"))
    bench["workloads"].append(dict(
        name=CELL, config=CONFIG_NAME, traffic="crs-closed1", chips=1,
        why="closed loop, 1 client, 4 instances: Crs, compacted chaining "
            "build of 2^24 S rows over 2^16 keys, key-direct probe of R, "
            "whole-chain walks, 2^24 pairs"))
    bench["per_layer"].append(dict(
        name=METRIC, unit="ms", better="lower", source="program_span",
        layer="probe strand", moves="rows_per_s", workloads=[CELL]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2) + "\n")
