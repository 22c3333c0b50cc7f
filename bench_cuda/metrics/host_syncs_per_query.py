"""Host calls that wait for the device in the traced span
(``measure.HOST_READS``: stream, device and event syncs, blocking copies),
a query; the harness's own counter read is one of them."""


def read(run):
    if run.trace is None or run.trace.queries == 0:
        return None
    return run.trace.host_reads / run.trace.queries
