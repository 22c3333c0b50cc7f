"""Rank bodies for the tests' gloo runs (spawned processes import them by
name): the harness with short CPU windows, with or without a planted
fault.  Rank 0, the test's own process, plants the same fault with
``monkeypatch`` and these functions."""

from __future__ import annotations

from bench_cuda import harness, ranks
from bench_cuda.entries import dist_nested
from hashjoin3d_tpu_torch.parallel import shuffle


def _quick():
    harness.SAMPLE_ROUNDS = 1
    harness.TRACE_FROM, harness.TRACE_QUERIES = 4, 2


def no_all_to_all(cols, group, async_op=False):
    """The exchange between ranks left out: each rank keeps its own send
    buffer as its receive."""
    return list(cols), []


_prepare = dist_nested.prepare


def half_probe_prepare(ctx, cols):
    """Every rank probes with half of its probe block."""
    step, build, probe = _prepare(ctx, cols)
    return step, build, probe[:probe.shape[0] // 2]


def worker(*args) -> None:
    _quick()
    ranks._worker(*args)


def worker_no_exchange(*args) -> None:
    _quick()
    shuffle.all_to_all = no_all_to_all
    ranks._worker(*args)


def worker_half(*args) -> None:
    _quick()
    dist_nested.prepare = half_probe_prepare
    ranks._worker(*args)
