"""A pool of gloo ranks for the port's distributed tests.

``RankPool(world, store)`` spawns ``world`` processes (``spawn`` start
method, one thread each), joins them in one gloo process group over a
``FileStore`` at ``store``, and keeps them for a test module: ``run(name,
*args)`` runs this module's function ``name`` on every rank and returns
the ranks' results in rank order.  The ranks import ``torch`` and the port
only (never ``jax``), so the module that holds the functions they run is
this one.  ``gathered`` folds the per-rank results of a join step: the
counters (equal on every rank) and every shard's rows.
"""

from __future__ import annotations

import datetime
import queue
import traceback

import numpy as np
import torch

#: seconds a collective may wait for a peer before it raises
COLLECTIVE_TIMEOUT = 60
#: seconds the parent waits for one request's answer
ANSWER_TIMEOUT = 180
#: the arrays of a step's result; every other key is a global counter
ROW_KEYS = ("probe_row", "build_row", "out_valid", "r_row", "s_row", "t_row",
            "group_keys", "group_count", "group_sum")


def _worker(rank: int, world: int, store: str, inbox, outbox) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    try:
        while True:
            msg = inbox.get()
            if msg is None:
                break
            name, args = msg
            try:
                outbox.put((rank, True, globals()[name](*args)))
            except Exception:  # reported to the test, which fails
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks, kept alive across requests."""

    def __init__(self, world: int, store: str):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_worker,
                                  args=(r, world, store, self.inboxes[r],
                                        self.outbox), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.broken = None

    def run(self, name: str, *args) -> list:
        if self.broken:
            raise RuntimeError(f"rank pool unusable: {self.broken}")
        for q in self.inboxes:
            q.put((name, args))
        got = {}
        try:
            for _ in range(self.world):
                rank, ok, value = self.outbox.get(timeout=ANSWER_TIMEOUT)
                got[rank] = (ok, value)
        except queue.Empty:
            self.broken = f"{name} gave no answer in {ANSWER_TIMEOUT} s"
            raise RuntimeError(self.broken) from None
        errors = [v for ok, v in got.values() if not ok]
        if errors:
            if len(errors) < self.world:  # a rank may wait on a dead peer
                self.broken = f"{name} failed on some ranks"
            raise AssertionError(f"{name} failed on a rank:\n{errors[0]}")
        return [got[r][1] for r in range(self.world)]

    def close(self) -> None:
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self.procs)


def gathered(results: list) -> tuple[dict, dict]:
    """``(counters, rows)`` of a step's per-rank results: each counter
    checked equal on every rank (they are summed over the mesh), each row
    column the ranks' columns concatenated in rank order."""
    counters = {k: v for k, v in results[0].items() if k not in ROW_KEYS}
    for r in results[1:]:
        for k, v in counters.items():
            assert r[k] == v, f"counter {k} differs between ranks"
    rows = {k: np.concatenate([r[k] for r in results])
            for k in results[0] if k in ROW_KEYS}
    return counters, rows


def pairs(rows: dict) -> list:
    """The valid (probe_row, build_row) pairs, sorted: a multiset."""
    v = rows["out_valid"]
    return sorted(zip(rows["probe_row"][v].tolist(),
                      rows["build_row"][v].tolist()))


def triples(rows: dict) -> list:
    v = rows["out_valid"]
    return sorted(zip(rows["r_row"][v].tolist(), rows["s_row"][v].tolist(),
                      rows["t_row"][v].tolist()))


# --- what the ranks run ------------------------------------------------------

_MESHES = {}


def _mesh(kind: str):
    """This rank's mesh of ``kind`` ("flat": the whole group on one axis;
    "2d": 2 x 2 (host, chip)), made once a process."""
    from hashjoin3d_tpu_torch import parallel

    if kind not in _MESHES:
        _MESHES[kind] = (parallel.make_mesh(device="cpu") if kind == "flat"
                         else parallel.make_mesh_2d(2, 2, device="cpu"))
    return _MESHES[kind]


def below_60(payload: torch.Tensor) -> torch.Tensor:
    """The pipeline tests' predicate."""
    return payload < 60


def below_1(payload: torch.Tensor) -> torch.Tensor:
    return payload < 1


def _host(v):
    if isinstance(v, torch.Tensor):
        return int(v) if v.dim() == 0 else v.numpy()
    return v


def run_step(entry: str, kwargs: dict, columns: list,
             mesh_kind: str = "flat") -> dict:
    """``parallel.<entry>(mesh, **kwargs)`` called with this rank's block
    of each global column; the result on the host (counters as ints).  A
    ``predicate`` given by name is one of this module's functions."""
    from hashjoin3d_tpu_torch import parallel

    mesh = _mesh(mesh_kind)
    kwargs = dict(kwargs)
    if isinstance(kwargs.get("predicate"), str):
        kwargs["predicate"] = globals()[kwargs["predicate"]]
    axis = "x" if mesh_kind == "flat" else ("host", "chip")
    step = getattr(parallel, entry)(mesh, **kwargs)
    out = step(*(parallel.shard_axis(mesh, c, axis) for c in columns))
    return {k: _host(v) for k, v in out.items()}


def probe_mesh_rules(world: int) -> dict:
    """``make_mesh``'s refusals and sizes on a live gloo group."""
    from hashjoin3d_tpu_torch import parallel

    seen = {}
    try:
        parallel.make_mesh(world + 1, device="cpu")
    except ValueError as e:
        seen["too_many"] = str(e)
    import torch.distributed as dist

    real = dist.get_backend
    dist.get_backend = lambda *a: "nccl"
    try:
        parallel.make_mesh(device="cpu")
    except ValueError as e:
        seen["nccl_cpu"] = str(e)
    finally:
        dist.get_backend = real
    try:
        parallel.make_mesh_2d(2, world, device="cpu")
    except ValueError as e:
        seen["too_many_2d"] = str(e)
    mesh = parallel.make_mesh(device="cpu")
    seen["size"] = mesh.size()
    seen["names"] = mesh.mesh_dim_names
    seen["block"] = parallel.shard_axis(mesh, np.arange(4 * world,
                                                        dtype=np.uint32))
    seen["block"] = seen["block"].tolist()
    return seen


def exchange(keys, capacity: int, sort_within_dest: bool) -> dict:
    """One ``partition_exchange`` of this rank's block of ``keys`` with its
    global rows: the receive on the host."""
    from hashjoin3d_tpu_torch import parallel
    from hashjoin3d_tpu_torch.parallel.mesh import axis_info

    mesh = _mesh("flat")
    group, ns, index = axis_info(mesh, "x")
    local = parallel.shard_axis(mesh, keys)
    rows = index * local.shape[0] + torch.arange(local.shape[0],
                                                 dtype=torch.int32)
    k, pay, valid, ovf = parallel.partition_exchange(
        group, local, {"row": rows}, ns, capacity,
        sort_within_dest=sort_within_dest)
    return dict(keys=k.numpy(), row=pay["row"].numpy(), valid=valid.numpy(),
                overflow=int(ovf))


def exchange_spans() -> tuple:
    """One ``partition_exchange`` (overflow reduced inside it) and one
    ``dist_nested_join`` step on its key_domain + n_keys route in a CPU
    profiler window: ``(root names, root name -> names under it, the
    parent name of each hj.exchange.reduce span, None for a root)``."""
    from torch.profiler import ProfilerActivity, profile

    from hashjoin3d_tpu_torch import parallel
    from hashjoin3d_tpu_torch.parallel.mesh import axis_info
    from hashjoin3d_tpu_torch.utils import tracing

    mesh = _mesh("flat")
    group, ns, index = axis_info(mesh, "x")
    g = torch.Generator().manual_seed(11 + index)
    domain = 256
    build = torch.randint(0, domain, (1024,), generator=g, dtype=torch.int32)
    probe = torch.arange(index * 128, (index + 1) * 128, dtype=torch.int32)
    step = parallel.dist_nested_join(mesh, 64, build_capacity=1024,
                                     probe_capacity=128, out_capacity=2048,
                                     key_domain=domain, n_keys=domain)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        parallel.partition_exchange(group, build, {"row": build}, ns, 1024)
        out = step(build, probe)
    recs = tracing.records()
    tracing.clear()
    assert int(out["overflow"]) == 0
    # no span with children runs an operator of its own
    for e in prof.events():
        up = e.cpu_parent
        while up is not None and not up.name.startswith("hj."):
            up = up.cpu_parent
        if up is not None and e.name.startswith("aten::"):
            assert not any(c.name.startswith("hj.") for c in prof.events()
                           if c.cpu_parent is up), (up.name, e.name)

    def root(r):
        while r.parent >= 0:
            r = recs[r.parent]
        return r

    tree = {}
    for r in recs:
        subs = tree.setdefault(root(r).name, set())
        if root(r) is not r:
            subs.add(r.name)
    return ([r.name for r in recs if r.parent < 0], tree,
            [recs[r.parent].name if r.parent >= 0 else None
             for r in recs if r.name == "hj.exchange.reduce"])


def fuzz_dist_trials(trials: int, seed: int, tier: str, cut=None) -> list:
    """``tools/fuzz_dist.py``'s trials on the pool's group (the CPU): rank
    0's reports, the other ranks' empty lists."""
    from hashjoin3d_tpu_torch.tools import fuzz_dist

    lines = []
    fuzz_dist.trials_on_group(torch.device("cpu"), trials, seed, tier, cut,
                              lines.append)
    return lines


def fuzz_dist_schedules(seed: int, trials) -> list:
    """This rank's results of small trials ``trials`` of ``fuzz_dist`` (its
    flat join and second schedule), drawn from ``seed``."""
    import torch.distributed as dist

    from hashjoin3d_tpu_torch.tools import fuzz_dist

    rng = np.random.default_rng(seed)
    cases = [fuzz_dist.small_case(rng, t, dist.get_world_size())
             for t in range(max(trials) + 1)]
    meshes = fuzz_dist.mesh_cache(torch.device("cpu"))
    return [fuzz_dist.schedules(cases[t], meshes, torch.device("cpu"))
            for t in trials]


def zipf_live(rk, sa, top, cap: int) -> dict:
    """``tools/zipf_capacity.py``'s live flat and hybrid joins on the
    pool's group (the CPU)."""
    from hashjoin3d_tpu_torch.tools import zipf_capacity

    return zipf_capacity.live_joins(torch.device("cpu"), rk, sa, top, cap)


def raising_body(dev, put, bad_rank: int) -> None:
    """A ``fuzzing.spawn_ranks`` body: rank ``bad_rank`` raises, the
    others report their rank."""
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise ValueError(f"planted on rank {bad_rank}")
    put("rank", dist.get_rank())
