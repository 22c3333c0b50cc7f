"""Segmented sorts of int32 columns (kernels K1 and K4).

Port of ``hashjoin3d_tpu/ops/bitonic.py``:

* :func:`bitonic_sort_segmented` (K4): sort every ``chunk``-sized segment
  ascending, 1-op or with an int32 payload; keys compare as u32
  (``unsigned=True``) or int32.  ``stable=True`` orders lexicographically by
  (key, payload); ``stable=False`` leaves the payload order of equal keys to
  the network (each payload still travels with its key).
* :func:`bitonic_sort_packed_segmented` (K1): sorted keys and segment-local
  row ids for keys below ``2^key_bits``; equal-key row order unspecified.

On CUDA tensors both launch ``csrc/bitonic.cu``; on CPU tensors they run
:func:`plain_sort_segmented`, a per-segment ``torch.sort`` that is
lexicographic by (key, payload) -- a valid result for every tie rule.
"""

from __future__ import annotations

import torch

from .. import kernels
from .layout import I32, I64, SIGN

#: Largest segment the bitonic kernels take (the TPU kernel's cap, kept so
#: the probe strands choose the same segment and window sizes).
MAX_SEGMENT_BITONIC = 1 << 18


def _check(keys: torch.Tensor, chunk: int, payload=None):
    n = keys.shape[0]
    if chunk & (chunk - 1) or not 256 <= chunk <= MAX_SEGMENT_BITONIC:
        raise ValueError(f"chunk must be a power of two in [256, "
                         f"{MAX_SEGMENT_BITONIC}], got {chunk}")
    if keys.dim() != 1 or keys.dtype != I32 or n % chunk:
        raise ValueError(f"keys must be int32 with a length divisible by "
                         f"{chunk}")
    if payload is not None and (payload.dtype != I32
                                or payload.shape != keys.shape):
        raise ValueError("payload must be int32 of the keys' shape")


def plain_sort_segmented(keys: torch.Tensor, chunk: int,
                         payload: torch.Tensor | None = None,
                         unsigned: bool = True):
    """Per-segment ascending sort, lexicographic by (key, payload), with
    ``torch.sort`` (any device, any power-of-two ``chunk``)."""
    K = keys.shape[0] // chunk
    k2 = (keys ^ SIGN if unsigned else keys).reshape(K, chunk)
    if payload is None:
        s = torch.sort(k2, dim=1).values.reshape(-1)
        return (s ^ SIGN if unsigned else s,)
    packed = (k2.to(I64) * (1 << 32)
              + (payload.reshape(K, chunk).to(I64) + (1 << 31)))
    s = torch.sort(packed, dim=1).values.reshape(-1)
    sk = (s >> 32).to(I32)
    sv = ((s & 0xFFFFFFFF) - (1 << 31)).to(I32)
    return (sk ^ SIGN if unsigned else sk, sv)


def bitonic_sort_segmented(keys: torch.Tensor, chunk: int,
                           payload: torch.Tensor | None = None,
                           unsigned: bool = True, stable: bool = True):
    """Sort ``chunk``-sized segments ascending; returns ``(sorted_keys,)``
    or ``(sorted_keys, sorted_payload)``."""
    _check(keys, chunk, payload)
    if keys.device.type == "cpu" and (payload is None
                                      or payload.device.type == "cpu"):
        return plain_sort_segmented(keys, chunk, payload, unsigned)
    ops = (keys,) if payload is None else (keys, payload)
    kernels.require_cuda("bitonic_sort_segmented", *ops)
    out_k = torch.empty_like(keys)
    out_v = None if payload is None else torch.empty_like(payload)
    rc = kernels.lib().hj3t_bitonic_sort_segmented(
        kernels.ptr(keys), kernels.ptr(payload), kernels.ptr(out_k),
        kernels.ptr(out_v), keys.shape[0], chunk.bit_length() - 1,
        int(unsigned), int(stable), kernels.stream(keys.device))
    kernels.count_launch(rc, "bitonic_sort_segmented")
    return (out_k,) if payload is None else (out_k, out_v)


def bitonic_sort_packed_segmented(keys: torch.Tensor, chunk: int,
                                  key_bits: int):
    """(sorted u32 keys, segment-local row ids) per ``chunk`` segment.

    REQUIRES every key below ``2^key_bits`` (the caller routes wider streams
    to :func:`bitonic_sort_segmented`); the kernel packs the first
    ``min(32 - key_bits, log2 chunk, 13)`` levels into one word.
    """
    _check(keys, chunk)
    if not 1 <= key_bits <= 31:
        raise ValueError(f"key_bits must be in [1, 31], got {key_bits}")
    if keys.device.type == "cpu":
        lid = torch.arange(keys.shape[0], dtype=I32) % chunk
        return plain_sort_segmented(keys, chunk, lid, unsigned=True)
    kernels.require_cuda("bitonic_sort_packed_segmented", keys)
    out_k = torch.empty_like(keys)
    out_r = torch.empty_like(keys)
    rc = kernels.lib().hj3t_bitonic_sort_packed_segmented(
        kernels.ptr(keys), kernels.ptr(out_k), kernels.ptr(out_r),
        keys.shape[0], chunk.bit_length() - 1, key_bits,
        kernels.stream(keys.device))
    kernels.count_launch(rc, "bitonic_sort_packed_segmented")
    return out_k, out_r
