"""The whole-chain walk's bucket-id sort (K4, ``csrc/radix.cu``) against
its bound: 8 bytes a probe key (read the int32 bucket id, write it sorted)
over the memory rate, in the device time of the kernels the traffic lists
under ``ops.walk_sort``.  In a Crs query nothing else launches those
kernels: its probe keys are a permutation and are not sorted (no K1), and
its build sorts with the library."""

from .. import measure

BUCKET_BYTES = 4  #: an int32 bucket id


def walk_sort_bytes(keys: int) -> int:
    """Sort the bucket ids of ``keys`` probe keys, one op with no payload:
    read the ids, write them sorted."""
    return keys * (BUCKET_BYTES + BUCKET_BYTES)


def read(run):
    spec = run.traffic.get("ops", {}).get("walk_sort")
    if spec is None or run.trace is None or run.trace.queries == 0:
        return None
    seconds = run.trace.kernel_s(spec["kernels"]) / run.trace.queries
    if seconds <= 0:
        return None
    work = walk_sort_bytes(int(run.config["rows"][spec["keys"]]))
    return 100 * measure.bound_ms(work) / (seconds * 1e3)
