"""``parallel.dist_nested_join`` on a mesh of every rank, on its
``key_domain`` and ``n_keys`` route: each rank calls the step with its
contiguous block of the build and the probe column.  Capacities come from
the configuration (``capacity_slack`` over the uniform means)."""

from __future__ import annotations

from hashjoin3d_tpu_torch import parallel


def _step(ctx):
    if "step" not in ctx.shared:
        c, t = ctx.config, ctx.traffic["table"]
        w = ctx.world
        rows = c["rows"]
        slack = 1 + c["capacity_slack"]
        nb, pb = rows[t["build"]] // w, rows[t["probe"]] // w
        mesh = parallel.make_mesh(w, device=ctx.device)
        ctx.shared["step"] = parallel.dist_nested_join(
            mesh, c["buckets_per_shard"],
            build_capacity=int(nb / w * slack),
            probe_capacity=int(pb / w * slack),
            out_capacity=int(rows[t["build"]] / w * slack),
            key_domain=c["key_domain"],
            n_keys=int(c["key_domain"] / w * slack))
    return ctx.shared["step"]


def prepare(ctx, cols):
    t = ctx.traffic["table"]

    def block(col):
        n = col.shape[0] // ctx.world
        return col[ctx.rank * n:(ctx.rank + 1) * n].clone()

    return _step(ctx), block(cols[t["build"]]), block(cols[t["probe"]])


def query(state, mark):
    step, build, probe = state
    mark("step")
    out = step(build, probe)
    mark(None)
    return out


def counters(out) -> dict:
    return {"matches": out["num_matches"], "cmps": out["num_cmps"],
            "total": out["num_unnested"], "overflow": out["overflow"]}


def route(out) -> int:
    return 0


def rows(out) -> dict:
    v = out["out_valid"]
    return {"probe_row": out["probe_row"].where(v, -1),
            "build_row": out["build_row"].where(v, -1)}
