"""An exp-4 plan: ``Experiment4(...)``'s ``build(plan, S)``, ``build(plan,
T)``, then ``probe(plan, S table, T table, R)``."""

from __future__ import annotations

from hashjoin3d_tpu_torch.models.exp4 import Experiment4


def prepare(ctx, cols):
    c = ctx.config
    exp = Experiment4(c["log2_card_r"], c["alpha"], c["mult_alpha"],
                      c["beta"], c["mult_beta"], device=ctx.device,
                      trace=False)
    return exp, ctx.traffic["plan"], cols["R"], cols["S"], cols["T"]


def query(state, mark):
    exp, plan, r, s, t = state
    mark("build")
    ts = exp.build(plan, s)
    tt = exp.build(plan, t)
    mark("probe")
    out = exp.probe(plan, ts, tt, r)
    mark(None)
    return out


def counters(out) -> dict:
    return {"rs": out["c_probe_RS"], "rs_cmp": out["c_probe_RS_cmp"],
            "rt": out["c_probe_RT"], "rt_cmp": out["c_probe_RT_cmp"],
            "unnest_t": out["c_unnest_1"], "total": out["c_unnest_2"]}


def route(out) -> int:
    return int(out["route_worst"])


def rows(out) -> dict:
    return {"r_row": out["r_row"], "s_row": out["s_row"],
            "t_row": out["t_row"]}
