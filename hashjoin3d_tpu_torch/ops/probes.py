"""Micro-kernels P1-P9: the Mosaic capability probes, on Hopper.

Port of the nine probes of ``tools/mosaic_probe.py``, which measured on the
TPU what the primitives of a radix probe sort cost.  Each function computes
exactly what its TPU probe's check pins, on int32 ``(rows, 128)`` arrays:

====  ======================  =============================================
P1    :func:`roll`            ``np.roll(x, shift, axis=1)``
P2    :func:`rotate`          row r rotated left by ``shifts[r]``
P3    :func:`cumsum`          cumsum along lanes, or down rows per block
P4    :func:`onehot_matmul`   ``x @ p`` for a 0/1 matrix p (tensor cores)
P5    :func:`permute`         one permutation applied inside every C-block
P6    :func:`masked_store`    x's first 8 rows, lanes < 64, at a row offset
P7    :func:`block_copy`      copy in reversed order of B-word blocks
P8    :func:`row_copy`        8 rows from a row offset not aligned to 8
P9    :func:`digit_histogram` per-row counts of the digits 0..15
====  ======================  =============================================

On CUDA tensors each launches its kernel in ``csrc/probes.cu``; on CPU
tensors it runs its plain version (``*_plain``, any device).
"""

from __future__ import annotations

import torch

from .. import kernels
from .layout import I32

LANES = 128


def _device(name: str, *tensors: torch.Tensor) -> int:
    """-1 if every operand lies on the CPU (take the plain version); else
    the CUDA device index, after the kernel's device rule (and 16-byte
    alignment)."""
    return kernels.kernel_device(name, *tensors, align=16)


def _rows_of(x: torch.Tensor, what: str) -> int:
    if x.dtype != I32 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"{what}: x must be int32 of shape (rows, {LANES})")
    return x.shape[0]


_ROLL = kernels.Kernel("hj3t_probe_roll")
_ROTATE = kernels.Kernel("hj3t_probe_rotate")
_CUMSUM = kernels.Kernel("hj3t_probe_cumsum")
_ONEHOT_MATMUL = kernels.Kernel("hj3t_probe_onehot_matmul")
_PERMUTE = kernels.Kernel("hj3t_probe_permute")
_MASKED_STORE = kernels.Kernel("hj3t_probe_masked_store")
_BLOCK_COPY = kernels.Kernel("hj3t_probe_block_copy")
_ROW_COPY = kernels.Kernel("hj3t_probe_row_copy")
_DIGIT_HISTOGRAM = kernels.Kernel("hj3t_probe_digit_histogram")


# ------------------------------------------------------------------ P1, P2
def roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """P1: ``np.roll(x, shift, axis=1)`` for a runtime ``shift``."""
    rows = _rows_of(x, "roll")
    dev = _device("probe_roll", x)
    if dev < 0:
        return roll_plain(x, shift)
    out = torch.empty_like(x)
    _ROLL("probe_roll", x.data_ptr(), out.data_ptr(), rows,
          int(shift) % LANES, kernels.stream(dev))
    return out


def roll_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    lane = torch.arange(LANES, device=x.device)
    return x[:, (lane - shift) % LANES]


def rotate(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P2: row r rotated left by ``shifts[r]`` (``np.roll(x[r], -s)``)."""
    rows = _rows_of(x, "rotate")
    if shifts.dtype != I32 or shifts.shape != (rows,):
        raise ValueError("rotate: shifts must be int32 of shape (rows,)")
    dev = _device("probe_rotate", x, shifts)
    if dev < 0:
        return rotate_plain(x, shifts)
    out = torch.empty_like(x)
    _ROTATE("probe_rotate", x.data_ptr(), shifts.data_ptr(), out.data_ptr(),
            rows, kernels.stream(dev))
    return out


def rotate_plain(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    lane = torch.arange(LANES, device=x.device, dtype=I32)
    idx = (lane[None, :] + shifts[:, None]) & (LANES - 1)
    return torch.gather(x, 1, idx.long())


# ---------------------------------------------------------------------- P3
def cumsum(x: torch.Tensor, axis: int, block_rows: int = 512) -> torch.Tensor:
    """P3: inclusive int32 cumsum along the lanes (``axis=1``) or down the
    rows within each block of ``block_rows`` rows (``axis=0``)."""
    rows = _rows_of(x, "cumsum")
    if axis not in (0, 1):
        raise ValueError(f"cumsum: axis must be 0 or 1, got {axis}")
    if axis == 0 and (block_rows % 8 or rows % block_rows):
        raise ValueError(f"cumsum: block_rows {block_rows} must be a "
                         f"multiple of 8 dividing rows {rows}")
    dev = _device("probe_cumsum", x)
    if dev < 0:
        return cumsum_plain(x, axis, block_rows)
    out = torch.empty_like(x)
    _CUMSUM("probe_cumsum", x.data_ptr(), out.data_ptr(), rows, axis,
            block_rows, kernels.stream(dev))
    return out


def cumsum_plain(x: torch.Tensor, axis: int,
                 block_rows: int = 512) -> torch.Tensor:
    if axis == 1:
        return torch.cumsum(x, 1, dtype=I32)
    return torch.cumsum(x.view(-1, block_rows, LANES), 1,
                        dtype=I32).view(x.shape)


# ---------------------------------------------------------------------- P4
def onehot_matmul(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """P4: ``x @ p`` for ``0 <= x < 2^24`` and ``p`` an int32 (128, 128)
    matrix of zeros and ones (a one-hot permutation in the probe), on the
    tensor cores: three u8 byte planes of x times p as u8, int32 sums,
    recombined."""
    rows = _rows_of(x, "onehot_matmul")
    if p.dtype != I32 or p.shape != (LANES, LANES):
        raise ValueError("onehot_matmul: p must be int32 (128, 128)")
    if rows % 16:
        raise ValueError(f"onehot_matmul: rows {rows} must be a multiple "
                         f"of 16")
    dev = _device("probe_onehot_matmul", x, p)
    if dev < 0:
        return onehot_matmul_plain(x, p)
    out = torch.empty_like(x)
    _ONEHOT_MATMUL("probe_onehot_matmul", x.data_ptr(), p.data_ptr(),
                   out.data_ptr(), rows, kernels.stream(dev))
    return out


def onehot_matmul_plain(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic: each byte plane of x times p (the kernel's
    u8 x u8 -> int32 products; here in float32, exact for the same reason:
    sums of at most 128 bytes), recombined in int32."""
    pf = p.float()
    out = torch.zeros_like(x)
    for plane in range(3):
        b = ((x >> (8 * plane)) & 255).float()
        out += (b @ pf).to(I32) << (8 * plane)
    return out


# ---------------------------------------------------------------------- P5
def permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """P5: ``out[bC + i] = x[bC + perm[i]]`` over the flattened x, with
    ``C = len(perm)`` (a multiple of 128, at most 8192) dividing x's size."""
    C = perm.shape[0]
    if x.dtype != I32 or perm.dtype != I32 or perm.dim() != 1:
        raise ValueError("permute: x and perm must be int32, perm 1-D")
    if C % LANES or C > 8192 or x.numel() % C:
        raise ValueError(f"permute: C = {C} must be a multiple of 128, at "
                         f"most 8192, dividing {x.numel()}")
    dev = _device("probe_permute", x, perm)
    if dev < 0:
        return permute_plain(x, perm)
    out = torch.empty_like(x)
    _PERMUTE("probe_permute", x.data_ptr(), perm.data_ptr(), out.data_ptr(),
             x.numel(), C, kernels.stream(dev))
    return out


def permute_plain(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    C = perm.shape[0]
    return x.reshape(-1, C)[:, perm.long()].reshape(x.shape)


# ---------------------------------------------------------------------- P6
def masked_store(x: torch.Tensor, off: int, out_rows: int = 32,
                 lanes: int = 64) -> torch.Tensor:
    """P6: a zeroed ``(out_rows, 128)`` array whose rows ``[off, off + 8)``,
    lanes ``< lanes``, hold x's first 8 rows.  (The TPU probe left the rest
    of its scratch undefined; here it is zero.)"""
    rows = _rows_of(x, "masked_store")
    if rows < 8 or not 0 <= off <= out_rows - 8 or not 0 <= lanes <= LANES:
        raise ValueError(f"masked_store: need 8 <= rows, 0 <= off <= "
                         f"out_rows - 8 and 0 <= lanes <= 128 (rows {rows}, "
                         f"off {off}, out_rows {out_rows}, lanes {lanes})")
    dev = _device("probe_masked_store", x)
    if dev < 0:
        return masked_store_plain(x, off, out_rows, lanes)
    out = x.new_empty((out_rows, LANES))
    _MASKED_STORE("probe_masked_store", x.data_ptr(), out.data_ptr(),
                  out_rows, off, lanes, kernels.stream(dev))
    return out


def masked_store_plain(x: torch.Tensor, off: int, out_rows: int = 32,
                       lanes: int = 64) -> torch.Tensor:
    out = torch.zeros((out_rows, LANES), dtype=I32, device=x.device)
    out[off:off + 8, :lanes] = x[:8, :lanes]
    return out


# ---------------------------------------------------------------------- P7
def block_copy(src: torch.Tensor, B: int) -> torch.Tensor:
    """P7: a copy of ``src`` made in reversed order of its ``B``-word blocks
    (B a multiple of 128 dividing the size): the result equals ``src``."""
    n = src.numel()
    if src.dtype != I32 or B <= 0 or B % LANES or n % B:
        raise ValueError(f"block_copy: int32 src, B = {B} a multiple of 128 "
                         f"dividing {n}")
    dev = _device("probe_block_copy", src)
    if dev < 0:
        return block_copy_plain(src, B)
    out = torch.empty_like(src)
    _BLOCK_COPY("probe_block_copy", src.data_ptr(), out.data_ptr(), n, B,
                kernels.stream(dev))
    return out


def block_copy_plain(src: torch.Tensor, B: int) -> torch.Tensor:
    K = src.numel() // B
    order = torch.arange(K - 1, -1, -1, device=src.device)
    out = torch.empty_like(src)
    out.view(K, B)[order] = src.reshape(K, B)[order]
    return out


# ---------------------------------------------------------------------- P8
def row_copy(src: torch.Tensor, off: int, nrows: int = 8) -> torch.Tensor:
    """P8: ``src[off:off + nrows]`` (1 <= nrows <= 64) from a row offset
    that need not be a multiple of 8, copied global to global, one 16-byte
    word a thread."""
    rows = _rows_of(src, "row_copy")
    if not 1 <= nrows <= 64 or not 0 <= off <= rows - nrows:
        raise ValueError(f"row_copy: need 1 <= nrows <= 64 and 0 <= off <= "
                         f"rows - nrows (rows {rows}, off {off}, nrows "
                         f"{nrows})")
    dev = _device("probe_row_copy", src)
    if dev < 0:
        return row_copy_plain(src, off, nrows)
    out = src.new_empty((nrows, LANES))
    _ROW_COPY("probe_row_copy", src.data_ptr(), out.data_ptr(), rows, off,
              nrows, kernels.stream(dev))
    return out


def row_copy_plain(src: torch.Tensor, off: int, nrows: int = 8):
    return src[off:off + nrows].clone()


# ---------------------------------------------------------------------- P9
def digit_histogram(x: torch.Tensor) -> torch.Tensor:
    """P9: ``out[r, v]`` = count of v in row r for v in 0..15, zeros in
    lanes 16..127 (values outside 0..15 are not counted)."""
    rows = _rows_of(x, "digit_histogram")
    dev = _device("probe_digit_histogram", x)
    if dev < 0:
        return digit_histogram_plain(x)
    out = torch.empty_like(x)
    _DIGIT_HISTOGRAM("probe_digit_histogram", x.data_ptr(), out.data_ptr(),
                     rows, kernels.stream(dev))
    return out


def digit_histogram_plain(x: torch.Tensor) -> torch.Tensor:
    digits = torch.arange(16, device=x.device, dtype=I32)
    out = torch.zeros_like(x)
    out[:, :16] = (x[:, :, None] == digits).sum(1, dtype=I32)
    return out
