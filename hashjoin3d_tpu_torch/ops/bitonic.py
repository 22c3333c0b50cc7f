"""Segmented sorts of int32 columns (kernels K1 and K4).

Port of ``hashjoin3d_tpu/ops/bitonic.py``; the names stay the JAX
package's, the kernels behind them are a segmented LSD radix sort
(``csrc/radix.cu``) and no longer a bitonic network:

* :func:`bitonic_sort_segmented` (K4): sort every ``chunk``-sized segment
  ascending, 1-op or with an int32 payload; keys compare as u32
  (``unsigned=True``) or int32.  ``stable=True`` orders lexicographically by
  (key, payload); ``stable=False`` sorts on the key alone (each payload still
  travels with its key; the kernel keeps equal keys in input order).
* :func:`bitonic_sort_packed_segmented` (K1): sorted keys and segment-local
  row ids for keys below ``2^key_bits``, in (key, row) order.

:func:`radix_plan` computes the kernels' passes: digit widths, bit offsets,
the column each digit comes from, and the scratch sizes.  On
CUDA tensors both wrappers launch ``csrc/radix.cu`` with that plan; on CPU
tensors they run :func:`plain_sort_segmented`, a per-segment ``torch.sort``
that is lexicographic by (key, payload) -- a valid result for every tie
rule.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from .layout import I32, I64, SIGN

_RADIX = kernels.Kernel("hj3t_radix_sort_segmented")

#: Largest segment the segmented kernels take (the TPU kernel's cap, kept so
#: the probe strands choose the same segment and window sizes).
MAX_SEGMENT_BITONIC = 1 << 18

#: Elements of one tile of a multi-tile pass (256 threads x 16) and the
#: largest segment one block sorts whole in shared memory (512 threads x 16):
#: ``kTile`` and ``kOneBlockMax`` of ``csrc/radix.cu``, whose entry point
#: rejects scratch smaller than its own layout needs.
RADIX_TILE = 4096
RADIX_ONE_BLOCK_MAX = 8192
#: Widest digit, ``kMaxBits`` there: 8 bits (K4: four digits; K1 at 20 bits:
#: 7 + 7 + 6).  Three 7-bit digits measured faster for K1 than two 10-bit
#: ones on the H100 (PERF.md).
RADIX_MAX_BITS = 8


class RadixPass(NamedTuple):
    column: int   #: 0 the keys, 1 the payload
    shift: int    #: the digit's lowest bit
    bits: int     #: the digit's width


class RadixPlan(NamedTuple):
    """The passes of one radix sort, least significant digit first."""
    passes: tuple
    flips: tuple      #: xor before taking digits: (keys, payload)
    chunk: int
    nops: int         #: columns moved: 1 (keys) or 2 (keys, payload/rows)

    @property
    def one_block(self) -> bool:
        return self.chunk <= RADIX_ONE_BLOCK_MAX

    def words(self) -> list[int]:
        """The plan as the kernel's int32 words: npass, the two flips, then
        (column, shift, bits) per pass."""
        return [len(self.passes), *self.flips,
                *(w for p in self.passes for w in p)]

    def scratch_words(self, n: int) -> dict:
        """int32 words of each scratch buffer for ``n`` keys (0: unused).
        The multi-tile path ping-pongs through ``tmp_keys`` (and
        ``tmp_payload``), keeps per-tile digit counts and per-segment bin
        totals, and ORs the columns into ``ors`` (zeroed)."""
        if self.one_block:
            return dict(tmp_keys=0, tmp_payload=0, counts=0, segtot=0,
                        ors=0)
        bins = 1 << max(p.bits for p in self.passes)
        return dict(tmp_keys=n, tmp_payload=n if self.nops == 2 else 0,
                    counts=n // RADIX_TILE * bins,
                    segtot=n // self.chunk * bins, ors=4)


def _digits(column: int, bits: int) -> list:
    """``bits`` low bits of a column in as few digits of at most
    ``RADIX_MAX_BITS`` as will do, widths as even as possible (20 -> 7 + 7
    + 6, 32 -> 4 x 8)."""
    npass = -(-bits // RADIX_MAX_BITS)
    base, extra = divmod(bits, npass)
    out, shift = [], 0
    for i in range(npass):
        w = base + (i < extra)
        out.append(RadixPass(column, shift, w))
        shift += w
    return out


def radix_plan(key_bits: int, chunk: int, nops: int, stable: bool,
               unsigned: bool = True) -> RadixPlan:
    """Pass plan of a segmented LSD radix sort of ``key_bits``-bit keys in
    ``chunk`` segments, moving ``nops`` columns.

    ``stable`` (2-op): the payload's 32 bits (as int32) are sorted first,
    then the key's, so the result is lexicographic by (key, payload).
    Otherwise only key digits run; a stable LSD sort keeps equal keys in
    input order, so K1's rows, which ascend on input, come out in (key, row)
    order.  Signed keys and payloads flip the sign bit before their digits
    are taken.  The ping-pong is not part of the plan: the kernel skips a
    pass whose digit is the same for every key, found on the device, and
    counts the parity over the passes that run, from the last one, which
    writes the output.
    """
    if not 1 <= key_bits <= 32 or nops not in (1, 2):
        raise ValueError(f"key_bits {key_bits} / nops {nops} out of range")
    digits = _digits(1, 32) if nops == 2 and stable else []
    return RadixPlan(tuple(digits + _digits(0, key_bits)),
                     (0 if unsigned else SIGN, SIGN), chunk, nops)


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


def _radix(name: str, plan: RadixPlan, dev: int, keys: torch.Tensor,
           payload: torch.Tensor | None, rows_from_pos: bool):
    """Allocate the outputs and the plan's scratch, launch ``csrc/radix.cu``
    on CUDA device ``dev`` and count the launch under ``name``."""
    n = keys.shape[0]
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(keys) if plan.nops == 2 else None
    sizes = plan.scratch_words(n)
    # held here until the launch is queued: a buffer dropped earlier goes
    # back to the allocator, which may hand its memory to the next one
    scratch = [None if not words else
               (torch.zeros if key == "ors" else torch.empty)(
                   words, dtype=I32, device=keys.device)
               for key, words in sizes.items()]
    words = plan.words()
    c_words = (ctypes.c_int * len(words))(*words)
    c_sizes = (ctypes.c_longlong * len(sizes))(*sizes.values())
    _RADIX(name, *[None if t is None else t.data_ptr() for t in
                   (keys, payload, out_k, out_v, *scratch)],
           ctypes.cast(c_words, ctypes.c_void_p),
           ctypes.cast(c_sizes, ctypes.c_void_p), n,
           plan.chunk.bit_length() - 1, int(rows_from_pos),
           kernels.stream(dev))
    return (out_k,) if out_v is None else (out_k, out_v)


def bitonic_sort_segmented(keys: torch.Tensor, chunk: int,
                           payload: torch.Tensor | None = None,
                           unsigned: bool = True, stable: bool = True):
    """Sort ``chunk``-sized segments ascending; returns ``(sorted_keys,)``
    or ``(sorted_keys, sorted_payload)``.  On CUDA: four 8-bit key digits,
    after four payload digits when ``stable``."""
    _check(keys, chunk, payload)
    ops = (keys,) if payload is None else (keys, payload)
    dev = kernels.kernel_device("bitonic_sort_segmented", *ops)
    if dev < 0:
        return plain_sort_segmented(keys, chunk, payload, unsigned)
    plan = radix_plan(32, chunk, len(ops), stable, unsigned)
    return _radix("bitonic_sort_segmented", plan, dev, keys, payload, False)


def bitonic_sort_packed_segmented(keys: torch.Tensor, chunk: int,
                                  key_bits: int):
    """(sorted u32 keys, segment-local row ids) per ``chunk`` segment, in
    (key, row) order.

    REQUIRES every key below ``2^key_bits`` (the caller routes wider streams
    to :func:`bitonic_sort_segmented`): the kernel sorts the low
    ``key_bits`` bits only, in ``ceil(key_bits / RADIX_MAX_BITS)`` digit
    passes, and makes the row ids from positions in its first pass.
    """
    _check(keys, chunk)
    if not 1 <= key_bits <= 31:
        raise ValueError(f"key_bits must be in [1, 31], got {key_bits}")
    dev = kernels.kernel_device("bitonic_sort_packed_segmented", keys)
    if dev < 0:
        lid = torch.arange(keys.shape[0], dtype=I32) % chunk
        return plain_sort_segmented(keys, chunk, lid, unsigned=True)
    plan = radix_plan(key_bits, chunk, 2, False)
    return _radix("bitonic_sort_packed_segmented", plan, dev, keys, None,
                  True)
