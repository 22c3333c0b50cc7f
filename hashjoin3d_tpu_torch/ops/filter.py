"""Selection and stream compaction.

Port of ``hashjoin3d_tpu/ops/filter.py``, the columnar ``AlgSelection`` /
``AlgDynSelection`` (``algebra.hh:279-358``): a predicate is a callable
over a column dict giving a liveness mask, masks flow through the builds
and probes (each takes one), and :func:`compact` packs a masked batch
densely where a consumer needs contiguous rows.
"""

from __future__ import annotations

import torch

from .layout import I32, I64


def apply_predicate(pred, columns: dict, mask: torch.Tensor | None = None):
    """``pred(columns)`` (a bool tensor) and'ed with ``mask``."""
    sel = pred(columns)
    return sel if mask is None else sel & mask


def compact(mask: torch.Tensor, columns: dict, out_size: int):
    """Pack the live rows into ``out_size`` slots (prefix sum, one scatter).

    Returns ``(packed_columns, row_ids, count)``: slots past ``count`` hold
    zeros (-1 for the row ids), live rows past ``out_size`` are cut, and
    ``count`` is an int64 device scalar.
    """
    n = mask.shape[0]
    dev = mask.device
    m = mask.to(I32)
    off = torch.cumsum(m, 0, dtype=I32) - m
    count = m.to(I64).sum()
    rows = torch.arange(n, dtype=I32, device=dev)
    # dead rows (and live ones past the buffer) to slots of their own
    tgt = torch.where(mask & (off < out_size), off, out_size + rows).long()
    row_ids = torch.full((out_size + n,), -1, dtype=I32, device=dev)
    row_ids[tgt] = rows
    packed = {}
    for k, v in columns.items():
        out = torch.zeros(out_size + n, dtype=v.dtype, device=dev)
        out[tgt] = v
        packed[k] = out[:out_size]
    return packed, row_ids[:out_size], count
