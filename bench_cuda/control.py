"""The control of a cell's check: the plain reference put in the
program's place at the next lower key width (u16 keys), judged against
the exact join of the u32 keys.  It has to come out not correct.

    python3 bench_cuda/control.py --workload <cell> --seeds 1,2,3

Runs at the cell's own sizes on one card (``--device cpu`` for a small
copy in tests), one data instance a seed, and prints one JSON line a seed
with each compared number beside its limit.  The benchmark's runs do not
run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers on data instance 0 of ``seed``."""
    from bench_cuda import spec
    from bench_cuda.recipes import instance_seed

    cfg, traffic = cell.config, cell.traffic
    recipe = spec.module("recipes", cfg["recipe"])
    ref = spec.module("references", traffic["reference"])
    cols = recipe.columns(cfg, instance_seed(seed, 0), device)
    expected = ref.expect(cols, cfg, traffic)
    return ref.control(cols, cfg, traffic, expected)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from bench_cuda import spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    limits = spec.module("references", cell.traffic["reference"]).LIMITS
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(cell, seed, device)
        failed = [k for k in limits if nums[k] > limits[k]]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": not failed, "failed": failed,
                          "checks": {k: {"value": nums[k],
                                         "limit": limits[k]}
                                     for k in limits}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
