"""One reader a metric, named as in ``BENCHMARK.json``:
``read(run) -> float | None`` takes the metric from a
:class:`~bench_cuda.harness.Run` and returns None where the run holds
nothing to read (the harness then leaves the metric out of the line)."""

from __future__ import annotations

from .. import measure, roofline


def roofline_pct(run, op: str):
    """Share of operation ``op``'s bound (its work from the shapes that
    the traffic's ``ops`` entry names, over the memory rate) in the device
    time a query spends in the kernels the entry lists; None without the
    entry, a trace or any such kernel."""
    spec = run.traffic.get("ops", {}).get(op)
    if spec is None or run.trace is None or run.trace.queries == 0:
        return None
    seconds = run.trace.kernel_s(spec["kernels"]) / run.trace.queries
    if seconds <= 0:
        return None
    work = roofline.op_bytes(op, spec, run.config["rows"])
    return 100 * measure.bound_ms(work) / (seconds * 1e3)
