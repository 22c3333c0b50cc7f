"""Carry table state from the JAX package into the port.

``chaining_table_from_numpy`` turns a JAX dense-direct ``ChainingTable``'s
arrays (after ``np.asarray``) into the port's table on ``device``, so the
port's probe strand can be held against a table the JAX package built.
"""

from __future__ import annotations

import numpy as np

from .ops.chaining import ChainingTable
from .ops.layout import from_numpy_u32

#: the JAX table fields the port's dense-direct table carries
FIELDS = ("bucket_start", "bucket_len", "pos_by_row", "keys", "direct")


def chaining_table_from_numpy(fields: dict[str, np.ndarray], *,
                              num_buckets: int, direct_shift: int,
                              hashfun: str, device) -> ChainingTable:
    """``fields`` maps each name of :data:`FIELDS` to a u32 or i32 numpy
    column; every column becomes its int32 carrier on ``device``."""
    missing = [f for f in FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing table fields {missing}")
    cols = {f: from_numpy_u32(np.asarray(fields[f]), device) for f in FIELDS}
    return ChainingTable(**cols, direct_shift=direct_shift,
                         num_buckets=num_buckets, hashfun=hashfun)
