"""Several ranks on one host: the calling process is rank 0, and ranks 1
.. world-1 are spawned processes; each takes card ``rank`` and joins one
process group (NCCL on cards, gloo on the CPU) over a file store in a
fresh directory under ``TMPDIR``, removed afterwards."""

from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import tempfile
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from . import harness, spec

#: how long a collective, or the group's start, may wait for a rank
TIMEOUT = timedelta(seconds=120)


def join_group(rank: int, world: int, store: str, device_type: str):
    """Join the process group; returns this rank's device."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world, timeout=TIMEOUT)
    return device


def _worker(bench: str, name: str, seed: int, seconds: float, trace: bool,
            rank: int, world: int, store: str, device_type: str) -> None:
    import time

    cell = spec.load_cell(name, Path(bench))
    device = join_group(rank, world, store, device_type)
    try:
        harness.run(cell, seed, seconds, trace, device, time.perf_counter(),
                    rank, world)
    finally:
        dist.destroy_process_group()


def launch(bench: Path, cell, seed: int, seconds: float, trace: bool,
           device_type: str, t_start: float, worker=_worker):
    """Run ``cell`` on ``cell.chips`` ranks; rank 0's result.  ``worker``
    is the spawned ranks' function (a module-level one, with
    :func:`_worker`'s arguments)."""
    world = cell.chips
    tmp = tempfile.mkdtemp(prefix="bench_cuda_ranks_")
    store = os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker,
                         args=(str(bench), cell.name, seed, seconds, trace,
                               r, world, store, device_type))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        device = join_group(0, world, store, device_type)
        try:
            res = harness.run(cell, seed, seconds, trace, device, t_start,
                              0, world)
        finally:
            dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(timeout=TIMEOUT.total_seconds())
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"ranks 1..{world - 1} exited with {codes}")
    return res
