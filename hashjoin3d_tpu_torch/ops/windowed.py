"""Windowed table lookup for (nearly) sorted key streams (kernels K2, K2b).

Port of ``hashjoin3d_tpu/ops/windowed.py``: ``windowed_lookup`` resolves
``table[key]`` chunk by chunk against one table window per ``C``-key chunk,
``[base, base + W + 1024)`` with ``base`` from :func:`chunk_bases`; a key
outside its chunk's window (negative, past the table, or too far below the
chunk's maximum) yields 0, the miss marker.  :func:`windowed_coverage_ok`
says whether every in-range key of a stream is covered;
:func:`windowed_lookup_covered` answers the lookups and says which chunks
are not, in one pass.

On CUDA tensors :func:`windowed_lookup` and :func:`windowed_lookup_covered`
launch ``csrc/windowed.cu``: K2, or with ``db=True`` K2b, the same gather
from L2 (no window is staged: each in-window key reads its word straight
from the table, which stays in L2).  On CPU tensors they run
:func:`windowed_lookup_plain` and :func:`windowed_lookup_covered_plain`.
"""

from __future__ import annotations

import torch

from .. import kernels
from .layout import I32, I64

DEFAULT_C = 1024
DEFAULT_W = 1024

_K2 = kernels.Kernel("hj3t_windowed_lookup")
_K2B = kernels.Kernel("hj3t_windowed_lookup_db")


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
    if W < 1024 or W & (W - 1):
        raise ValueError(f"W must be a power of two >= 1024 ({W})")
    if T < W + 1024 or T % 1024:
        raise ValueError(f"table size {T} must be a multiple of 1024 and "
                         f">= W + 1024")


def windowed_lookup(table: torch.Tensor, keys_sorted: torch.Tensor,
                    C: int = DEFAULT_C, W: int = DEFAULT_W,
                    db: bool = False) -> torch.Tensor:
    """``table[keys]`` with miss-as-0 for keys outside their chunk window.

    ``table``: int32[T] (u32 carrier), T >= W + 1024 and T % 1024 == 0;
    ``keys_sorted``: int32[n], n % C == 0, nearly nondecreasing (-1 holes
    are fine).  Coverage of in-range keys is the caller's to check
    (:func:`windowed_lookup_covered`, ``strands_windowed.safe_lookup``).
    ``db=True`` launches K2b, the counterpart of the JAX package's
    double-buffered kernel (same code and results).
    """
    _check(table, keys_sorted, C, W)
    name = "windowed_lookup_db" if db else "windowed_lookup"
    dev = kernels.kernel_device(name, table, keys_sorted)
    if dev < 0:
        return windowed_lookup_plain(table, keys_sorted, C, W)
    out = torch.empty_like(keys_sorted)
    T, n = table.shape[0], keys_sorted.shape[0]
    if db:
        _K2B(name, table.data_ptr(), keys_sorted.data_ptr(), out.data_ptr(),
             T, n, C, W, kernels.stream(dev))
    else:
        _K2(name, table.data_ptr(), keys_sorted.data_ptr(), out.data_ptr(),
            None, T, T, n, C, W, kernels.stream(dev))
    return out


def windowed_lookup_covered(table: torch.Tensor, keys_sorted: torch.Tensor,
                            Tv: int, C: int = DEFAULT_C,
                            W: int = DEFAULT_W):
    """:func:`windowed_lookup` that also reports its window coverage:
    ``(out, bad, nbad)``, with ``bad`` int32[n // C] 1 for each chunk that
    holds a key in ``[0, Tv)`` outside its window (0 else) and ``nbad`` the
    count of such chunks, an int32 scalar tensor on the keys' device.
    ``Tv <= T`` is the table's length before padding."""
    _check(table, keys_sorted, C, W)
    T, n = table.shape[0], keys_sorted.shape[0]
    if not 0 <= Tv <= T:
        raise ValueError(f"Tv = {Tv} must lie in [0, T = {T}]")
    dev = kernels.kernel_device("windowed_lookup", table, keys_sorted)
    if dev < 0:
        return windowed_lookup_covered_plain(table, keys_sorted, Tv, C, W)
    out = torch.empty_like(keys_sorted)
    bad = keys_sorted.new_empty(n // C + 1)  # the flags, then their count
    _K2("windowed_lookup", table.data_ptr(), keys_sorted.data_ptr(),
        out.data_ptr(), bad.data_ptr(), T, Tv, n, C, W, kernels.stream(dev))
    return out, bad[:-1], bad[-1]


def _in_window(keys_sorted: torch.Tensor, T: int, C: int,
               W: int) -> torch.Tensor:
    """(chunks, C) bool: each key lies in its chunk's window."""
    delta = (keys_sorted.reshape(-1, C).to(I64)
             - chunk_bases(keys_sorted, T, C, W).to(I64)[:, None])
    return (delta >= 0) & (delta < W + 1024)


def _gather_in_window(table: torch.Tensor, keys_sorted: torch.Tensor,
                      in_window: torch.Tensor) -> torch.Tensor:
    val = table[keys_sorted.clamp(0, table.shape[0] - 1).long()]
    return torch.where(in_window.reshape(-1), val, 0)


def windowed_lookup_plain(table: torch.Tensor, keys_sorted: torch.Tensor,
                          C: int = DEFAULT_C,
                          W: int = DEFAULT_W) -> torch.Tensor:
    """Exact PyTorch version of :func:`windowed_lookup` (any device)."""
    return _gather_in_window(table, keys_sorted, _in_window(
        keys_sorted, table.shape[0], C, W))


def windowed_lookup_covered_plain(table: torch.Tensor,
                                  keys_sorted: torch.Tensor, Tv: int,
                                  C: int = DEFAULT_C, W: int = DEFAULT_W):
    """Exact PyTorch version of :func:`windowed_lookup_covered`: the plain
    lookup and ``safe_lookup``'s chunk test (any device)."""
    in_window = _in_window(keys_sorted, table.shape[0], C, W)
    k2 = keys_sorted.reshape(-1, C)
    bad = ((k2 >= 0) & (k2 < Tv) & ~in_window).any(dim=1).to(I32)
    return (_gather_in_window(table, keys_sorted, in_window), bad,
            bad.sum(dtype=I32))


def windowed_coverage_ok(keys_sorted: torch.Tensor, T: int,
                         C: int = DEFAULT_C, W: int = DEFAULT_W) -> bool:
    """True iff every in-range key of every chunk lands in its window."""
    pad = (-keys_sorted.shape[0]) % C
    if pad:  # -1 is a miss marker: it moves no window
        keys_sorted = torch.cat([keys_sorted, keys_sorted.new_full((pad,), -1)])
    k2 = keys_sorted.reshape(-1, C)
    in_range = (k2 >= 0) & (k2 < T)
    return bool(torch.where(in_range, _in_window(keys_sorted, T, C, W),
                            True).all())
