"""Device ms a query of the kernels the traffic lists under
``ops.collective`` (NCCL's) in rank 0's traced span."""


def read(run):
    spec = run.traffic.get("ops", {}).get("collective")
    if spec is None or run.trace is None or run.trace.queries == 0:
        return None
    s = run.trace.kernel_s(spec["kernels"])
    return s / run.trace.queries * 1e3 if s > 0 else None
