"""An exp-1 join plan: ``Experiment1(...).join_plan(plan)``, its
``build`` over the build column, then its ``probe`` strand over the probe
column.  The benchmark's columns stand in for ``init()``'s; ``rk``,
``sa``, ``num_dv_sa`` and ``dense_direct_r`` are set as ``init()`` sets
them."""

from __future__ import annotations

import numpy as np
import torch

from hashjoin3d_tpu_torch.models.exp1 import Experiment1
from hashjoin3d_tpu_torch.ops.chaining import can_use_dense_direct


def prepare(ctx, cols):
    c = ctx.config
    exp = Experiment1(c["log2_card_r"], c["log2_card_s"], skew=False,
                      t=c["t"], b=c["b"], device=ctx.device, trace=False)
    exp.rk, exp.sa = cols["R"], cols["S"]
    exp.num_dv_sa = int(torch.bincount(cols["S"].long()).count_nonzero())
    exp.dense_direct_r = can_use_dense_direct(
        cols["R"].cpu().numpy().view(np.uint32), max(exp.card_r // exp.b, 1))
    return exp.join_plan(ctx.traffic["plan"])


def query(plan, mark):
    mark("build")
    table = plan.build(plan.build_keys)
    mark("probe")
    out = plan.probe(table, plan.probe_keys)
    mark(None)
    return out


def counters(out) -> dict:
    return {"matches": out["c_htProbe"], "cmps": out["c_htProbeCmp"],
            "total": out["total"]}


def route(out) -> int:
    return int(out["route_worst"])


def rows(out) -> dict:
    return {"probe_row": out["probe_row"], "build_row": out["build_row"]}
