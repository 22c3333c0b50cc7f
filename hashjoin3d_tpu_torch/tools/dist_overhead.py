"""The distributed path's overhead on one rank.

Port of ``tools/dist_overhead.py``.  The same workload runs through

(a) ``dist_nested_join`` on a 1-rank mesh (on a card with no process
    group yet, ``make_mesh`` starts a 1-rank NCCL group) by its three
    shard-local routes: the default one (the exchange of both sides, the
    clarity build under the receive's mask, ``probe_nested`` +
    ``unnest``), the windowed one (``key_domain``: the key-sorted probe
    exchange probed presorted) and the fast one (``key_domain`` +
    ``n_keys``: the fused compacted build with global row ids), and
(b) the single-chip fast path: the compacted build
    (``build_nested_host`` with ``n_keys`` and ``key_domain``) and the
    key_direct windowed strand over the probe column,

2^n build and 2^n probe keys drawn uniformly over a 2^(n-2)-key domain
(seed 5), each timed by the reference's protocol
(``utils/measure.repeat_mintime``: at least ``--min-time`` seconds and
``--reps`` runs, each ending in a device sync) after one untimed run.
The ratio of each (a) to (b) is what the distributed machinery costs
when the mesh collapses to one device; all four must give the same
number of result pairs.

    python3 -m hashjoin3d_tpu_torch.tools.dist_overhead [--n 22]

The card and its power limit print first, then one line a path and one
JSON line.  Without a CUDA GPU it raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..ops.layout import key_column, resolve_device
from ..ops.nested import build_nested_host
from ..ops.strands_windowed import keydirect_nested_strand_sorted
from ..parallel import dist_nested_join, make_mesh
from ..utils.measure import card, repeat_mintime, require_cuda

#: (label, dist_nested_join options) of the distributed paths
ROUTES = (("dist default", {}), ("dist windowed", {"key_domain": True}),
          ("dist fast", {"key_domain": True, "n_keys": True}))


def measure(log2_n: int = 22, min_time_s: float = 0.3, reps: int = 8,
            device=None) -> dict:
    """Times (ms a run) of the three 1-rank distributed routes and of the
    single-chip fast path, their ratios to it, and the result count.
    ``device`` defaults to the first CUDA GPU (a CPU run checks the code
    path only: its times are the CPU's)."""
    dev = require_cuda() if device is None else resolve_device(device)
    n = 1 << log2_n
    dom = n // 4
    rng = np.random.default_rng(5)
    bk_np = rng.integers(0, dom, n, dtype=np.uint32)
    pk_np = rng.integers(0, dom, n, dtype=np.uint32)
    ndv = int(np.unique(bk_np).size)
    bk, pk = key_column(bk_np, dev), key_column(pk_np, dev)
    out_cap = 8 * n
    mesh = make_mesh(1, device=dev)

    ms, totals = {}, {}
    for label, opts in ROUTES:
        step = dist_nested_join(
            mesh, ndv, n, n, out_cap,
            key_domain=dom if opts.get("key_domain") else None,
            n_keys=ndv if opts.get("n_keys") else None)
        step(bk, pk)  # warm-up, untimed
        total, runs, out = repeat_mintime(min_time_s, lambda: step(bk, pk),
                                          dev, reps)
        if int(out["overflow"]):
            raise RuntimeError(f"{label}: overflow {int(out['overflow'])}")
        ms[label] = total / runs * 1e3
        totals[label] = int(out["num_unnested"])

    def single():
        tbl = build_nested_host(bk, ndv, n_keys=ndv, key_domain=dom)
        return keydirect_nested_strand_sorted(tbl, pk, out_cap)

    single()
    total, runs, out = repeat_mintime(min_time_s, single, dev, reps)
    ms["single"] = total / runs * 1e3
    totals["single"] = int(out["c_unnest"])
    if len(set(totals.values())) != 1:
        raise RuntimeError(f"result counts differ: {totals}")
    return dict(rows_per_side=n, key_domain=dom, results=totals["single"],
                ms=ms, ratio={k: v / ms["single"] for k, v in ms.items()
                              if k != "single"})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=22, help="log2 rows a side")
    ap.add_argument("--min-time", type=float, default=0.3)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    require_cuda()
    print(card())
    r = measure(args.n, args.min_time, args.reps)
    print(f"rows/side {r['rows_per_side']}, results {r['results']}")
    print(f"single-chip fast path: {r['ms']['single']:.3f} ms")
    for label, _ in ROUTES:
        print(f"{label} @ 1 rank: {r['ms'][label]:.3f} ms "
              f"({r['ratio'][label]:.2f}x)")
    print(json.dumps(r))


if __name__ == "__main__":
    main()
