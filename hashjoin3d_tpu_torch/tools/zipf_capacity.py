"""Zipf distributed-capacity check at exp-1 scale.

Port of ``tools/zipf_capacity.py``.  For exp-1's zipf(1.0) key column
(``--skew -t 0``: |S| = 2^logp over a 2^logr domain) and a ``shards``-way
hash partition it

* counts the exact per-shard and per-(src, dst) receive volumes of the
  exchange, with and without replicating ``detect_skew``'s top-16 keys,
  twice: with the port's ``shard_of_key`` on ``dev`` and with its numpy
  host mirror (the double murmur), which must agree exactly;
* gives both joins one uniform per-(src, dst) probe capacity, the mean
  volume plus :data:`SLACK` (25%, the JAX tool's), and requires the flat
  exchange to exceed it and the cold-only one to fit;
* runs the flat join (it must report overflow) and the hybrid join (no
  overflow, ``num_matches`` = ``num_unnested`` = |S| exactly) live on
  :data:`LIVE_RANKS` gloo ranks at R18/S22, the cut ``chip_smoke.py``
  phase 11c takes (on ``cuda`` every rank's tensors sit on the one card).
  Four shards spread the zipf head wider than eight, so the live run's
  capacity comes from its own volumes: the midpoint of the cold-only and
  the flat exchange's largest per-(src, dst) volume.

    python3 -m hashjoin3d_tpu_torch.tools.zipf_capacity [--logp 24]
        [--logr 20] [--shards 8] [--no-run] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops.hashing import hash_key_np
from ..ops.layout import key_column, resolve_device
from ..parallel import detect_skew, shard_of_key
from ..utils.gen import exp1_data
from ..utils.measure import card
from .fuzzing import spawn_ranks

#: the uniform capacity's margin over the mean per-(src, dst) volume
SLACK = 0.25
#: the live run's cut and its gloo ranks (its shards)
LIVE_LOGR, LIVE_LOGP, LIVE_RANKS = 18, 22, 4


class CapacityFailure(AssertionError):
    """The volumes or the live joins disagree with what the check needs."""


def require(cond, what: str) -> None:
    if not cond:
        raise CapacityFailure(what)


def receive_volumes(keys: np.ndarray, shards: int, top, dev) -> dict:
    """Per-shard and largest per-(src, dst) receive volume of the
    exchange of ``keys`` (each of ``shards`` sources sending its block),
    all rows ("flat") and without the ``top`` keys ("cold"); counted by
    ``shard_of_key`` on ``dev`` and by the host mirror, held equal."""
    n = keys.size
    src = np.arange(n) // (n // shards)
    cold = ~np.isin(keys, top)
    host = (hash_key_np(hash_key_np(keys)) % np.uint32(shards)).astype(
        np.int64)
    on_dev = shard_of_key(key_column(keys, dev), shards).to(torch.int64)
    src_t = torch.from_numpy(src).to(on_dev.device)
    cold_t = torch.from_numpy(cold).to(on_dev.device)
    out = {}
    for name, mask, mask_t in (("flat", None, None),
                               ("cold", cold, cold_t)):
        pair = np.bincount(src * shards + host, minlength=shards * shards,
                           weights=None if mask is None
                           else mask.astype(np.float64)).astype(np.int64)
        pair_t = torch.bincount(src_t * shards + on_dev,
                                weights=None if mask_t is None
                                else mask_t.to(torch.float64),
                                minlength=shards * shards).to(torch.int64)
        require(np.array_equal(pair_t.cpu().numpy(), pair),
                f"{name}: shard_of_key on {dev} and the host mirror give "
                "different per-(src, dst) receive counts")
        out[name] = dict(per_shard=pair.reshape(shards, shards).sum(0),
                         max_pair=int(pair.max()))
    out["hot_rows"] = int(n - cold.sum())
    return out


def volumes(dev, log, logp: int, logr: int, shards: int) -> dict:
    """The receive volumes at R``logr``/S``logp`` on ``shards`` shards;
    returns the columns and the top keys with them."""
    rk, sa, _ = exp1_data(logr, logp, True, 0)
    rep = detect_skew(sa, shards)
    top = rep["top_keys"]
    log(f"|R|=2^{logr} (permutation), |S|=2^{logp} zipf(1.0), {shards} "
        f"shards; detect_skew: top_key_fraction "
        f"{rep['top_key_fraction']:.4f}, shard_imbalance "
        f"{rep['shard_imbalance']:.3f}, strategy {rep['strategy']}")
    v = receive_volumes(sa, shards, top, dev)
    for name, label in (("flat", "flat exchange per-shard receive: "),
                        ("cold", f"cold-only (top-{len(top)} replicated): ")):
        ps = v[name]["per_shard"]
        log(label + " ".join(str(x) for x in ps)
            + f"  (max/mean {ps.max() / max(ps.mean(), 1):.3f}, max "
            f"per-(src,dst) {v[name]['max_pair']}; {dev} = host mirror)")
    log(f"replicated hot volume: {v['hot_rows']} rows "
        f"({100 * v['hot_rows'] / sa.size:.1f}% of probes) never exchanged")
    return dict(rk=rk, sa=sa, top=top, volumes=v)


def require_split(v: dict, cap: int) -> None:
    """The flat exchange's largest per-(src, dst) volume must exceed
    ``cap`` and the cold-only one fit it."""
    flat, cold = v["flat"]["max_pair"], v["cold"]["max_pair"]
    require(flat > cap, f"the flat exchange fits the capacity {cap} (max "
            f"per-(src,dst) {flat})")
    require(cold <= cap, f"the cold exchange exceeds the capacity {cap} "
            f"(max per-(src,dst) {cold})")


def live_capacity(v: dict) -> int:
    """The live run's per-(src, dst) probe capacity: the midpoint of the
    cold-only and the flat exchange's largest volume (``v``, of
    :func:`receive_volumes`), which splits them."""
    cap = (v["flat"]["max_pair"] + v["cold"]["max_pair"]) // 2
    require_split(v, cap)
    return cap


def live_joins(dev, rk, sa, top, cap: int) -> dict:
    """The flat and the hybrid join on this rank's blocks of ``rk`` (build)
    and ``sa`` (probe), one mesh over the initialised process group (every
    rank calls this); their counters."""
    from .. import parallel

    mesh = parallel.make_mesh(device=dev)
    world = mesh.size()
    bk = parallel.shard_axis(mesh, rk)
    pk = parallel.shard_axis(mesh, sa)
    common = dict(num_buckets_per_shard=max(1, rk.size // world),
                  build_capacity=rk.size, probe_capacity=cap,
                  out_capacity=2 * (sa.size // world))
    got = {}
    for name, step in (
            ("flat", parallel.dist_nested_join(mesh, **common)),
            ("hybrid", parallel.dist_hybrid_nested_join(
                mesh, top, hot_build_capacity=32, **common))):
        out = step(bk, pk)
        got[name] = {k: int(v) for k, v in out.items() if v.dim() == 0}
    return got


def _rank_live(dev, put, rk, sa, top, cap):
    """One rank of the live run (a :func:`fuzzing.spawn_ranks` body)."""
    put("result", live_joins(dev, rk, sa, top, cap))


def live(dev, log, logp: int = LIVE_LOGP, logr: int = LIVE_LOGR) -> dict:
    """The live flat and hybrid joins at R``logr``/S``logp`` on
    :data:`LIVE_RANKS` gloo ranks; returns their counters."""
    v = volumes(dev, log, logp, logr, LIVE_RANKS)
    cap = live_capacity(v["volumes"])
    got = {}
    t0 = time.perf_counter()
    spawn_ranks(_rank_live, LIVE_RANKS, dev, v["rk"], v["sa"], v["top"],
                cap, on_message=lambda msg: got.__setitem__(msg[0], msg[2]))
    res = got[0]
    require(all(g == res for g in got.values()),
            "live run: counters differ between ranks")
    n_p = v["sa"].size
    flat, hyb = res["flat"], res["hybrid"]
    log(f"live on {LIVE_RANKS} gloo ranks ({dev}), R{logr}/S{logp}, "
        f"capacity {cap}: flat join overflow rows {flat['overflow']}; "
        f"hybrid overflow {hyb['overflow']}, matches {hyb['num_matches']} "
        f"(expect {n_p}), unnested {hyb['num_unnested']}  "
        f"[{time.perf_counter() - t0:.1f} s]")
    require(flat["overflow"] > 0, "the flat join reported no overflow")
    require(hyb["overflow"] == 0, f"the hybrid join overflowed "
            f"({hyb['overflow']} rows)")
    require(hyb["num_matches"] == n_p and hyb["num_unnested"] == n_p,
            "the hybrid join's counters are not |S|")
    return res


def run(dev, log, logp=24, logr=20, shards=8, no_run=False) -> dict:
    """The volume check at R``logr``/S``logp`` on ``shards`` shards under
    the uniform capacity, then (unless ``no_run``) the live joins; returns
    the volumes and the live counters."""
    dev = resolve_device(dev)
    v = volumes(dev, log, logp, logr, shards)["volumes"]
    cap = int((1 << logp) / shards / shards * (1 + SLACK))
    log(f"uniform per-(src,dst) capacity (mean + {SLACK:.0%}): {cap}")
    require_split(v, cap)
    out = dict(volumes=v)
    if not no_run:
        out["live"] = live(dev, log)
    log("OK")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logp", type=int, default=24)
    ap.add_argument("--logr", type=int, default=20)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--no-run", action="store_true",
                    help="volumes only, no live joins")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = vars(ap.parse_args(argv))
    dev = resolve_device(args.pop("device"))
    if dev.type == "cuda":
        print(card(), flush=True)
    run(dev, lambda line: print(line, flush=True), **args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
