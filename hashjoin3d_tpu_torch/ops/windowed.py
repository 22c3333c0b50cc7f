"""Windowed table lookup for (nearly) sorted key streams (kernel K2).

Port of ``hashjoin3d_tpu/ops/windowed.py``: ``windowed_lookup`` resolves
``table[key]`` chunk by chunk against one table window per ``C``-key chunk,
``[base, base + W + 1024)`` with ``base`` from :func:`chunk_bases`; a key
outside its chunk's window (negative, past the table, or too far below the
chunk's maximum) yields 0, the miss marker.  :func:`windowed_coverage_ok`
says whether every in-range key of a stream is covered.

On CUDA tensors :func:`windowed_lookup` launches ``csrc/windowed.cu``; on CPU
tensors it runs :func:`windowed_lookup_plain`.
"""

from __future__ import annotations

import torch

from .. import kernels
from .layout import I32, I64

DEFAULT_C = 1024
DEFAULT_W = 1024


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def chunk_bases(keys_sorted: torch.Tensor, T: int, C: int,
                W: int) -> torch.Tensor:
    """Window base per ``C``-key chunk: ``(kmax - W)`` in int32 arithmetic,
    aligned down to 1024 and clamped into ``[0, T - (W + 1024)]``."""
    kmax = keys_sorted.reshape(-1, C).amax(dim=1).to(I64)
    base = _wrap_i32(kmax - W) & ~1023
    return base.clamp(0, max(T - (W + 1024), 0)).to(I32)


def _check(table: torch.Tensor, keys: torch.Tensor, C: int, W: int):
    T, n = table.shape[0], keys.shape[0]
    if table.dtype != I32 or keys.dtype != I32:
        raise ValueError("table and keys must be int32 carriers")
    if n % C or C % 128:
        raise ValueError(f"C must be a multiple of 128 dividing n ({n}, {C})")
    if W < 1024 or W & (W - 1) or W > 32768:
        raise ValueError(f"W must be a power of two in [1024, 32768] ({W})")
    if T < W + 1024 or T % 1024:
        raise ValueError(f"table size {T} must be a multiple of 1024 and "
                         f">= W + 1024")


def windowed_lookup(table: torch.Tensor, keys_sorted: torch.Tensor,
                    C: int = DEFAULT_C, W: int = DEFAULT_W) -> torch.Tensor:
    """``table[keys]`` with miss-as-0 for keys outside their chunk window.

    ``table``: int32[T] (u32 carrier), T >= W + 1024 and T % 1024 == 0;
    ``keys_sorted``: int32[n], n % C == 0, nearly nondecreasing (-1 holes
    are fine).  Coverage of in-range keys is the caller's to check
    (:func:`windowed_coverage_ok`, ``strands_windowed.safe_lookup``).
    """
    _check(table, keys_sorted, C, W)
    if table.device.type == "cpu" and keys_sorted.device.type == "cpu":
        return windowed_lookup_plain(table, keys_sorted, C, W)
    kernels.require_cuda("windowed_lookup", table, keys_sorted)
    if table.data_ptr() % 16:
        raise ValueError("windowed_lookup: table must be 16-byte aligned")
    out = torch.empty_like(keys_sorted)
    rc = kernels.lib().hj3t_windowed_lookup(
        kernels.ptr(table), kernels.ptr(keys_sorted), kernels.ptr(out),
        table.shape[0], keys_sorted.shape[0], C, W,
        kernels.stream(table.device))
    kernels.count_launch(rc, "windowed_lookup")
    return out


def windowed_lookup_plain(table: torch.Tensor, keys_sorted: torch.Tensor,
                          C: int = DEFAULT_C,
                          W: int = DEFAULT_W) -> torch.Tensor:
    """Exact PyTorch version of :func:`windowed_lookup` (any device)."""
    T = table.shape[0]
    bases = chunk_bases(keys_sorted, T, C, W).to(I64)
    delta = keys_sorted.reshape(-1, C).to(I64) - bases[:, None]
    in_window = ((delta >= 0) & (delta < W + 1024)).reshape(-1)
    val = table[keys_sorted.clamp(0, T - 1).long()]
    return torch.where(in_window, val, 0)


def windowed_coverage_ok(keys_sorted: torch.Tensor, T: int,
                         C: int = DEFAULT_C, W: int = DEFAULT_W) -> bool:
    """True iff every in-range key of every chunk lands in its window."""
    pad = (-keys_sorted.shape[0]) % C
    if pad:  # -1 is a miss marker: it moves no window
        keys_sorted = torch.cat([keys_sorted, keys_sorted.new_full((pad,), -1)])
    k2 = keys_sorted.reshape(-1, C).to(I64)
    delta = k2 - chunk_bases(keys_sorted, T, C, W).to(I64)[:, None]
    in_range = (k2 >= 0) & (k2 < T)
    return bool(torch.where(in_range, (delta >= 0) & (delta < W + 1024),
                            True).all())
