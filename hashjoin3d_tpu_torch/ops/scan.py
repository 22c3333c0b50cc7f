"""Fused inclusive scans over parallel int32 columns (kernel K3).

Port of ``hashjoin3d_tpu/ops/scan.py`` ``multi_scan`` / ``engine_multi_scan``:
N inclusive scans, forward or reverse, in one pass over equal-length int32
columns.  Ops: ``"sum"`` (wraps in int32), ``"max"``, ``"min"`` (one column
each) and ``"maxpair"`` (two columns, key then payload, combined by
lexicographic maximum).

On CUDA tensors this launches ``csrc/scan.cu``; on CPU tensors it runs
:func:`multi_scan_plain`, the exact PyTorch version.
"""

from __future__ import annotations

import torch

from .. import kernels
from .layout import I32, I64, i64_to_u32

_OP_CODES = {"sum": 0, "max": 1, "min": 2, "maxpair": 3}
_ARITY = {"sum": 1, "max": 1, "min": 1, "maxpair": 2}
_MAX_SLOTS = 4


def _validate(arrays, ops):
    if isinstance(arrays, torch.Tensor):
        arrays = (arrays,)
    if isinstance(ops, str):
        ops = (ops,)
    arrays, ops = tuple(arrays), tuple(ops)
    for op in ops:
        if op not in _OP_CODES:
            raise ValueError(f"unknown scan op {op!r}")
    if sum(_ARITY[op] for op in ops) != len(arrays):
        raise ValueError(f"ops {ops} do not match {len(arrays)} columns")
    n = arrays[0].shape[0]
    for a in arrays:
        if a.dtype != I32 or a.shape != (n,):
            raise ValueError("scan columns must be int32 of one 1-D shape")
    return arrays, ops


def multi_scan(arrays, ops, reverse: bool = False):
    """Inclusive prefix scans of parallel int32 columns; returns the flat
    tuple of scanned columns (``reverse=True`` scans right to left)."""
    arrays, ops = _validate(arrays, ops)
    if arrays[0].device.type == "cpu":
        return multi_scan_plain(arrays, ops, reverse)
    kernels.require_cuda("multi_scan", *arrays)
    if len(arrays) > _MAX_SLOTS:
        raise ValueError(f"at most {_MAX_SLOTS} columns per fused scan")
    n = arrays[0].shape[0]
    outs = tuple(torch.empty_like(a) for a in arrays)
    if n == 0:
        return outs
    lib = kernels.lib()
    nblocks = -(-n // lib.hj3t_scan_tile())
    scratch = torch.empty(2 * len(ops) * nblocks, dtype=I32,
                          device=arrays[0].device)
    pad = [None] * (_MAX_SLOTS - len(arrays))
    codes = [_OP_CODES[op] for op in ops] + [-1] * (_MAX_SLOTS - len(ops))
    rc = lib.hj3t_multi_scan(
        *map(kernels.ptr, list(arrays) + pad), *map(kernels.ptr, list(outs) + pad),
        *codes, n, int(reverse), kernels.ptr(scratch),
        kernels.stream(arrays[0].device))
    kernels.count_launch(rc, "multi_scan")
    return outs


def multi_scan_plain(arrays, ops, reverse: bool = False):
    """Exact PyTorch version of :func:`multi_scan` (any device)."""
    arrays, ops = _validate(arrays, ops)

    def fwd(x):
        return x.flip(0) if reverse else x

    outs = []
    slot = 0
    for op in ops:
        x = fwd(arrays[slot])
        if op == "sum":
            outs.append(fwd(torch.cumsum(x, 0, dtype=I32)))
        elif op == "max":
            outs.append(fwd(torch.cummax(x, 0).values))
        elif op == "min":
            outs.append(fwd(torch.cummin(x, 0).values))
        else:  # maxpair == cummax of (key << 32 | biased payload) in int64
            k = x.to(I64)
            v = fwd(arrays[slot + 1]).to(I64)
            m = torch.cummax(k * (1 << 32) + (v + (1 << 31)), 0).values
            outs.append(fwd((m >> 32).to(I32)))
            outs.append(fwd(i64_to_u32((m & 0xFFFFFFFF) - (1 << 31))))
        slot += _ARITY[op]
    return tuple(outs)
