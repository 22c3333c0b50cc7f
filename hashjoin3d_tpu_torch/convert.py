"""Carry table state from the JAX package into the port.

``chaining_table_from_numpy`` turns a JAX ``ChainingTable``'s arrays
(after ``np.asarray``) into the port's table on ``device``, and
``nested_table_from_numpy`` does the same for a JAX ``NestedTable``, each
in either layout (dense-direct or compacted), so the port's probe strands
can be held against tables the JAX package built.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.chaining import ChainingTable
from .ops.layout import GroupIndex, I32, empty_group_index, from_numpy_u32
from .ops.nested import NestedTable

#: the JAX table fields the port's dense-direct chaining table carries
FIELDS = ("bucket_start", "bucket_len", "pos_by_row", "keys", "direct")
#: fields carried when present (CsrUU's ``full_chain_index``, the
#: compacted table's ``key_direct``)
OPTIONAL_FIELDS = ("chain_by_key", "key_direct")
#: the directory a compacted table carries, ``groups.n_keys`` a scalar
GROUP_FIELDS = ("groups.ukey", "groups.group_start", "groups.group_len",
                "groups.group_rows", "groups.first_row", "groups.gid_by_row",
                "groups.n_keys")
#: the fields of a compacted chaining table (the early-exit index arrays
#: are empty on a table built without it)
CHAINING_FIELDS = ("bucket_start", "bucket_len", "pos_by_row",
                   "group_min_pos", "group_chain_first", "keys",
                   *GROUP_FIELDS)
#: the fields of a dense-direct nested table
NESTED_DENSE_FIELDS = ("bucket_main_len", "keys", "direct")
#: the fields of a compacted nested table, ``groups.*`` its GroupIndex
NESTED_FIELDS = ("main_pos_by_group", "bucket_main_len", "keys",
                 "key_direct", *GROUP_FIELDS)


def _present(fields: dict, name: str) -> bool:
    """A field is absent when missing, None or ``np.asarray(None)``."""
    v = fields.get(name)
    return v is not None and np.asarray(v).dtype != object


def _columns(fields: dict, names, device) -> dict:
    missing = [f for f in names if f not in fields]
    if missing:
        raise KeyError(f"missing table fields {missing}")
    return {f: from_numpy_u32(np.asarray(fields[f]), device) for f in names}


def _group_index(cols: dict, fields: dict, device) -> GroupIndex:
    """Pop the ``groups.*`` columns of ``cols`` into a GroupIndex."""
    return GroupIndex(
        **{f.split(".")[1]: cols.pop(f) for f in GROUP_FIELDS
           if f != "groups.n_keys"},
        n_keys=torch.tensor(int(fields["groups.n_keys"]), dtype=I32,
                            device=device))


def chaining_table_from_numpy(fields: dict[str, np.ndarray], *,
                              num_buckets: int, hashfun: str, device,
                              direct_shift: int = 0) -> ChainingTable:
    """A JAX ``ChainingTable`` as the port's.  A dense-direct table
    (``fields`` has ``direct``) carries :data:`FIELDS` and
    ``direct_shift``; a compacted one :data:`CHAINING_FIELDS`.  Either
    carries the :data:`OPTIONAL_FIELDS` it has.  Every column becomes its
    int32 carrier on ``device``."""
    if _present(fields, "direct"):
        cols = _columns(fields, FIELDS, device)
        groups = None
    else:
        cols = _columns(fields, [f for f in CHAINING_FIELDS
                                 if f != "groups.n_keys"], device)
        groups = _group_index(cols, fields, device)
    for f in OPTIONAL_FIELDS:
        if _present(fields, f):
            cols[f] = from_numpy_u32(np.asarray(fields[f]), device)
    return ChainingTable(**cols, groups=groups, direct_shift=direct_shift,
                         num_buckets=num_buckets, hashfun=hashfun)


def nested_table_from_numpy(fields: dict[str, np.ndarray], *,
                            num_buckets: int, hashfun: str, device,
                            direct_shift: int = 0) -> NestedTable:
    """A JAX ``NestedTable`` as the port's.  A dense-direct table
    (``fields`` has ``direct``) carries :data:`NESTED_DENSE_FIELDS` and
    ``direct_shift``; a compacted one carries :data:`NESTED_FIELDS`
    (``groups.n_keys`` a scalar)."""
    if _present(fields, "direct"):
        cols = _columns(fields, NESTED_DENSE_FIELDS, device)
        n = cols["keys"].shape[0]
        return NestedTable(groups=empty_group_index(n, torch.device(device)),
                           main_pos_by_group=torch.zeros(
                               0, dtype=I32, device=device),
                           num_buckets=num_buckets, hashfun=hashfun,
                           direct_shift=direct_shift, **cols)
    cols = _columns(fields, [f for f in NESTED_FIELDS
                             if f != "groups.n_keys"], device)
    groups = _group_index(cols, fields, device)
    return NestedTable(groups=groups, num_buckets=num_buckets,
                       hashfun=hashfun, **cols)
