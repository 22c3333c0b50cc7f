"""Experiment 4 CLI of the port: two joins with deferred unnesting.

Mirrors the reference executable's interface (``main_experiment4.cc:
1048-1161``) and the JAX package's ``exp4.py``::

  python3 -m hashjoin3d_tpu_torch.exp4 -R 24 -a 4 -A 4 -b 2 -B 2 \\
      --measure-file - [-p Ndu,Chj,Nnu] [--no-run] [--print-relations]

``-p all`` runs the reference's runnable plans (Ndu, Chj); Nnu, declared
but not implemented by the reference, runs when named.  Runs on the first
CUDA GPU unless ``--device cpu`` asks for the CPU (plain PyTorch versions
of every kernel); ``cuda`` on a host without a GPU fails.
``--backend host`` runs the join plans on the native C++ host engine
(``auto``: the plans under the harness's ``HOST_CROSSOVER_ROWS``); the
default is the device.  The measurement
CSV is column-compatible with the reference binary's.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Hash Table Experiment 4: Two Joins w/ Deferred "
        "Unnesting (PyTorch/CUDA port)")
    ap.add_argument("-R", "--card-R", type=int, required=True,
                    help="cardinality of key relation R as log2")
    ap.add_argument("-a", "--alpha", type=int, required=True,
                    help="log2 fraction of keys referenced by both S and T")
    ap.add_argument("-b", "--beta", type=int, required=True,
                    help="log2 fraction of keys referenced by exactly one "
                    "of S/T")
    ap.add_argument("-A", "--alpha-mult", type=int, required=True,
                    help="multiplicity of common FKs")
    ap.add_argument("-B", "--beta-mult", type=int, required=True,
                    help="multiplicity of exclusive FKs")
    ap.add_argument("--measure-file", required=True,
                    help="CSV output path ('-' for stdout)")
    ap.add_argument("-p", "--plans", default="all",
                    help="comma-separated plans (Ndu,Chj,Nnu,all) or numeric "
                    "plans_e bitmask values (e.g. 1,4 = Ndu,Chj)")
    run_g = ap.add_mutually_exclusive_group()
    run_g.add_argument("--run", dest="run", action="store_true", default=True)
    run_g.add_argument("--no-run", dest="run", action="store_false")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the GPU (default) or, with the kernels' "
                    "plain PyTorch versions, on the CPU")
    ap.add_argument("--backend", default="device",
                    choices=("device", "host", "auto"),
                    help="execution backend: the device (default), the "
                    "native C++ host engine, or auto (small plans to the "
                    "host engine)")
    ap.add_argument("--print-timers", action="store_true")
    ap.add_argument("--print-relations", action="store_true")
    ap.add_argument("--print-paramtable", action="store_true")
    ap.add_argument("--min-time-ms", type=float, default=300.0,
                    help="repeat plans until this cumulative time")
    ap.add_argument("--min-repeat", type=int, default=8)
    ap.add_argument("--allow-route", type=int, default=0, choices=(0, 1, 2),
                    help="max tolerated route_worst before the run FAILS "
                    "(0 = demand the pure windowed route everywhere, "
                    "2 = never fail)")
    args = ap.parse_args(argv)
    if not 0 <= args.card_R <= 30:
        print("-R must be in [0, 30]", file=sys.stderr)
        return 1
    if not (0 <= args.alpha <= args.card_R and 0 <= args.beta <= args.card_R):
        print("-a/-b must be in [0, -R]", file=sys.stderr)
        return 1

    print("Running Experiment 4 with the following config:")
    for k in ("card_R", "alpha", "beta", "alpha_mult", "beta_mult",
              "measure_file", "plans", "device", "backend"):
        print(f"  --{k.replace('_', '-')} {getattr(args, k)}")

    from .models.exp4 import Experiment4

    exp = Experiment4(
        args.card_R, args.alpha, args.alpha_mult, args.beta, args.beta_mult,
        measure_file=None if args.measure_file == "-" else args.measure_file,
        plans=args.plans.split(","),
        min_runtime_s=args.min_time_ms / 1e3, min_repeat=args.min_repeat,
        assert_route=None if args.allow_route >= 2 else args.allow_route,
        device=args.device, backend=args.backend)
    exp.print_config()
    exp.init()
    if args.print_relations:
        exp.print_relations()
    if args.run:
        exp.run()
    if args.print_paramtable:
        Experiment4.print_param_table()
    if args.print_timers:
        print("Timers:")
        exp.print_timers()
    return 0


if __name__ == "__main__":
    sys.exit(main())
