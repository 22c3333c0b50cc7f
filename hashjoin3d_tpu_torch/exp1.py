"""Experiment 1 CLI of the port: the key/foreign-key hash join benchmark.

Mirrors the reference executable's interface (``main_experiment1.cc:
1374-1461``) and the JAX package's ``exp1.py``::

  python3 -m hashjoin3d_tpu_torch.exp1 -R 20 -S 24 --no-skew -t 0 -b 1 \\
      --measure-file - -p all,CsrSel,CrsSel,NrsSel

Runs on the first CUDA GPU unless ``--device cpu`` asks for the CPU (plain
PyTorch versions of every kernel); ``cuda`` on a host without a GPU fails.
``--backend host`` runs the join plans on the native C++ host engine
(``auto``: the plans under the harness's ``HOST_CROSSOVER_ROWS``); the
default is the device.
The measurement CSV is column-compatible with the reference binary's.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Hash Table Experiment 1 (PyTorch/CUDA port)")
    ap.add_argument("-R", "--card-R", type=int, required=True,
                    help="cardinality of key relation R as log2")
    ap.add_argument("-S", "--card-S", type=int, required=True,
                    help="cardinality of FK relation S as log2")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--skew", dest="skew", action="store_true",
                   help="zipf(1.0) foreign keys")
    g.add_argument("--no-skew", dest="skew", action="store_false",
                   help="uniform foreign keys")
    ap.add_argument("-t", "--param-t", type=int, required=True,
                    help="FK domain scale: S.a in [0, |R|/2^t)")
    ap.add_argument("-b", "--param-b", type=int, default=1,
                    choices=range(1, 5),
                    help="bucket scale-down: #buckets = #dv/b")
    ap.add_argument("--measure-file", required=True,
                    help="CSV output path ('-' for stdout)")
    ap.add_argument("-p", "--plans", default="all",
                    help="comma-separated plans (scr,scs,Csr,CsrUU,Crs,Nsr,"
                    "Nrs,NrsNU,all; plus CsrSel,CrsSel,NrsSel, the "
                    "reference's declared-only selection plans, which 'all' "
                    "leaves out like its ALL mask) or numeric plans_e "
                    "bitmask values (e.g. 4,8 = Csr,Crs)")
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
    ap.add_argument("--min-time-ms", type=float, default=300.0,
                    help="repeat plans until this cumulative time")
    ap.add_argument("--min-repeat", type=int, default=8)
    ap.add_argument("--allow-route", type=int, default=0, choices=(0, 1, 2),
                    help="max tolerated route_worst before the run FAILS "
                    "(0 = demand the pure windowed route everywhere, "
                    "2 = never fail)")
    args = ap.parse_args(argv)

    if args.param_t > args.card_R:
        print("--param-t must not be greater than --card-R", file=sys.stderr)
        return 1
    if not (0 <= args.card_R <= 30 and 0 <= args.card_S <= 30):
        print("-R/-S must be in [0, 30]", file=sys.stderr)
        return 1

    print("Running Experiment 1 with the following config:")
    for k in ("card_R", "card_S", "skew", "param_t", "param_b",
              "measure_file", "plans", "device", "backend"):
        print(f"  --{k.replace('_', '-')} {getattr(args, k)}")

    from .models.exp1 import Experiment1

    exp = Experiment1(
        args.card_R, args.card_S, args.skew, args.param_t, b=args.param_b,
        measure_file=None if args.measure_file == "-" else args.measure_file,
        plans=args.plans.split(","),
        min_runtime_s=args.min_time_ms / 1e3, min_repeat=args.min_repeat,
        assert_route=None if args.allow_route >= 2 else args.allow_route,
        device=args.device, backend=args.backend)
    exp.init()
    if args.print_relations:
        exp.print_relations()
    exp.run()
    if args.print_timers:
        print("Timers:")
        exp.print_timers()
    print("----")
    return 0


if __name__ == "__main__":
    sys.exit(main())
