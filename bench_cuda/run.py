"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 bench_cuda/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs as many CUDA cards as the cell asks for, and the program
(``hashjoin3d_tpu_torch``) beside this folder; exits non-zero, printing no
result, without them, or when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``hashjoin3d_tpu`` has been imported once the window has closed.
Earlier lines (standard error) name the cards, their clocks and power
beside the window, and the numbers compared with their limits, last.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names no run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "hashjoin3d_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), compared whole: ``hashjoin3d_tpu_torch`` is not
    ``hashjoin3d_tpu``."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None
                                      else names)}
    return sorted(tops & set(FORBIDDEN))


def result_line(cell, run, checks, limits, attempted, failed, trace,
                kind) -> dict:
    """The last line: the contract's keys, the compared numbers last."""
    from bench_cuda import spec

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": run.world,
              "memory_peak_bytes": run.peak_bytes}
    line = {"correct": all(checks[k] <= limits[k] for k in limits),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device}
    if trace and run.busy:
        device["busy_s"] = sum(b for b, _ in run.busy) / len(run.busy)
        device["window_s"] = sum(w for _, w in run.busy) / len(run.busy)
    if trace and run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                      for k in limits}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_cuda import harness, ranks, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    harness.log(f"cell {cell.name} on {cell.chips} x {kind} "
                f"(of {torch.cuda.device_count()}), torch "
                f"{torch.__version__}, CUDA {torch.version.cuda}, seed "
                f"{args.seed}, {args.seconds} s, trace {args.trace}")
    if cell.chips == 1:
        res = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    else:
        from hashjoin3d_tpu_torch import kernels
        kernels.lib()  # built once, before the ranks start
        res = ranks.launch(spec.BENCHMARK, cell, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    run, checks, attempted, failed = res
    limits = harness.limits(spec.module("references",
                                        cell.traffic["reference"]))
    line = result_line(cell, run, checks, limits, attempted, failed,
                       bool(args.trace), kind)
    for name, v in line["metrics"].items():
        harness.log(f"metric {name} = {v['value']!r} {v['unit']}")
    for name, c in line["checks"].items():
        harness.log(f"check {name} = {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
