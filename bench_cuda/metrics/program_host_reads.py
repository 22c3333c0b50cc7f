"""Device-to-host reads a query that the program counted inside its
``hj.build`` and ``hj.probe`` spans (``tracing.host_read``, by site); the
harness's own counter read is not among them."""

from ..program_trace import host_reads


def read(run):
    return host_reads(run)
