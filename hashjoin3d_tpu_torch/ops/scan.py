"""Fused inclusive scans over parallel int32 columns (kernel K3).

Port of ``hashjoin3d_tpu/ops/scan.py`` ``multi_scan`` / ``engine_multi_scan``:
N inclusive scans, forward or reverse, in one pass over equal-length int32
columns.  Ops: ``"sum"`` (wraps in int32), ``"max"``, ``"min"`` (one column
each) and ``"maxpair"`` (two columns, key then payload, combined by
lexicographic maximum).

On CUDA tensors this launches ``csrc/scan.cu``: one kernel a call, a
single-pass chained scan over tiles of :func:`tile` elements.  Its
workspace (each tile's published aggregate and prefix) is kept per CUDA
stream, zeroed once when allocated, and the kernel leaves it clean for the
next call on that stream, so a call allocates nothing but its outputs.  On
CPU tensors it runs :func:`multi_scan_plain`, the exact PyTorch version.
"""

from __future__ import annotations

import torch

from .. import kernels
from .layout import I32, I64, i64_to_u32

_OP_CODES = {"sum": 0, "max": 1, "min": 2, "maxpair": 3}
_ARITY = {"sum": 1, "max": 1, "min": 1, "maxpair": 2}
_MAX_SLOTS = 4
_K3 = kernels.Kernel("hj3t_multi_scan")
_TILE = 0
#: (device index, stream handle) -> (capacity in tiles, data_ptr, tensor)
_WORKSPACES: dict = {}
#: ops tuple -> (columns, op codes padded to 4 groups)
_OP_PLANS: dict = {}


def tile() -> int:
    """Elements a tile of the kernel, read once from ``csrc/scan.cu``."""
    global _TILE
    if not _TILE:
        _TILE = kernels.lib().hj3t_scan_tile()
    return _TILE


def scan_plan(n: int, tile: int, cap: int = 0) -> tuple[int, int]:
    """``(tiles, capacity)``: the tiles of a call over ``n`` elements, and
    the workspace capacity (in tiles, a multiple of 4) that serves it given
    a stream's current capacity ``cap``: ``cap`` itself when it suffices,
    else at least twice ``cap``, so a growing size reallocates rarely."""
    tiles = -(-n // tile)
    if tiles <= cap:
        return tiles, cap
    return tiles, -(-max(tiles, 2 * cap) // 4) * 4


def workspace_words(cap: int) -> int:
    """int32 words of a workspace for ``cap`` tiles: a finish count (4
    words), then per tile a 64-bit aggregate word and a 64-bit prefix word
    for each of the 4 column slots."""
    return 4 + 16 * cap


def _op_codes(ops: tuple) -> tuple[int, list[int]]:
    """Columns ``ops`` take and their codes, padded with -1 to 4 groups;
    checked once per tuple of ops."""
    plan = _OP_PLANS.get(ops)
    if plan is None:
        for op in ops:
            if op not in _OP_CODES:
                raise ValueError(f"unknown scan op {op!r}")
        codes = [_OP_CODES[op] for op in ops]
        plan = _OP_PLANS[ops] = (sum(_ARITY[op] for op in ops),
                                 codes + [-1] * (_MAX_SLOTS - len(codes)))
    return plan


def _validate(arrays, ops):
    if isinstance(arrays, torch.Tensor):
        arrays = (arrays,)
    if isinstance(ops, str):
        ops = (ops,)
    arrays, ops = tuple(arrays), tuple(ops)
    ncols, codes = _op_codes(ops)
    if ncols != len(arrays):
        raise ValueError(f"ops {ops} do not match {len(arrays)} columns")
    n = arrays[0].shape[0]
    for a in arrays:
        if a.dtype != I32 or a.shape != (n,):
            raise ValueError("scan columns must be int32 of one 1-D shape")
    return arrays, ops, codes


def _workspace(dev: int, stream: int, n: int, like: torch.Tensor):
    """The stream's workspace as ``(capacity, data_ptr)``, grown (and
    zeroed) when ``n`` needs more tiles than it holds."""
    ws = _WORKSPACES.get((dev, stream))
    cap = ws[0] if ws is not None else 0
    _, need = scan_plan(n, tile(), cap)
    if need != cap:
        buf = torch.zeros(workspace_words(need), dtype=I32, device=like.device)
        ws = _WORKSPACES[(dev, stream)] = (need, buf.data_ptr(), buf)
    return ws[0], ws[1]


def multi_scan(arrays, ops, reverse: bool = False):
    """Inclusive prefix scans of parallel int32 columns; returns the flat
    tuple of scanned columns (``reverse=True`` scans right to left)."""
    arrays, ops, codes = _validate(arrays, ops)
    dev = kernels.kernel_device("multi_scan", *arrays)
    if dev < 0:
        return multi_scan_plain(arrays, ops, reverse)
    if len(arrays) > _MAX_SLOTS:
        raise ValueError(f"at most {_MAX_SLOTS} columns per fused scan")
    n = arrays[0].shape[0]
    outs = tuple(torch.empty_like(a) for a in arrays)
    if n == 0:
        return outs
    stream = kernels.stream(dev)
    cap, ws = _workspace(dev, stream, n, arrays[0])
    pad = [None] * (_MAX_SLOTS - len(arrays))
    _K3("multi_scan", *[a.data_ptr() for a in arrays], *pad,
        *[o.data_ptr() for o in outs], *pad, *codes, n, int(reverse), ws,
        cap, stream)
    return outs


def multi_scan_plain(arrays, ops, reverse: bool = False):
    """Exact PyTorch version of :func:`multi_scan` (any device)."""
    arrays, ops, _ = _validate(arrays, ops)

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
