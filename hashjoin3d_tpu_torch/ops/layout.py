"""Integer carriers and the run-structure primitives of the builds.

Port of ``hashjoin3d_tpu/ops/layout.py`` (the parts the dense chaining build
uses).  PyTorch's ``uint32`` has no add, shifts, ``<``, ``%``, cummax or
scatter, so every u32 column rides as the int32 tensor with the same bits:

* add and multiply wrap exactly as u32;
* an unsigned compare or sort flips the sign bit first (``x ^ SIGN``);
* a logical right shift is :func:`shr`;
* arithmetic that must see the unsigned value widens to int64 with
  :func:`u32_to_i64` and comes back through :func:`i64_to_u32`.

Counters are int64.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
#: int32 sign bit: ``x ^ SIGN`` maps u32 order onto int32 order
SIGN = -0x80000000
U32_MASK = 0xFFFFFFFF


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device the host lacks
    (the port never falls back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def from_numpy_u32(a: np.ndarray, device) -> torch.Tensor:
    """A host u32 (or i32) column as the int32 carrier on ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"expected a 32-bit integer column, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(resolve_device(device))


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int32 carrier, as int64."""
    return x.to(I64) & U32_MASK


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor as the int32 carrier."""
    x = x & U32_MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int32 carrier by ``0 < k < 32``."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def run_boundaries(skey: torch.Tensor, n_valid: int):
    """Run-length structure of a sorted key column, gather-free.

    Returns ``(is_first, gid, run_start, run_len)`` per sorted element from
    one fused forward scan (sum, max) and one reverse min scan
    (``ops/scan.py``, kernel K3 on the GPU).
    """
    from .scan import multi_scan

    n = skey.shape[0]
    i = torch.arange(n, dtype=I32, device=skey.device)
    vs = i < n_valid
    is_first = torch.ones(n, dtype=torch.bool, device=skey.device)
    is_first[1:] = skey[1:] != skey[:-1]
    is_first &= vs
    gid1, run_start = multi_scan(
        (is_first.to(I32), torch.where(is_first, i, -1)), ("sum", "max"))
    gid = gid1 - 1
    # start of the NEXT run, filled from the right
    nxt = torch.full((n,), n, dtype=I32, device=skey.device)
    nxt[:-1] = torch.where(is_first, i, n)[1:]
    (nxt_min,) = multi_scan((nxt,), ("min",), reverse=True)
    next_start = torch.clamp(nxt_min, max=n_valid)
    run_len = torch.where(vs, next_start - run_start, 0)
    return is_first, gid, run_start, run_len


def sorted_histogram(b_sorted: torch.Tensor, num_buckets: int,
                     is_first: torch.Tensor, run_len: torch.Tensor):
    """Bucket histogram of an already-sorted bucket column: each run's
    length lands at its bucket (values >= ``num_buckets`` fall off an extra
    slot).  Returns ``(bucket_start, bucket_len)``, both int32[num_buckets].
    """
    tgt = torch.where(is_first, b_sorted, num_buckets).long()
    blen = torch.zeros(num_buckets + 1, dtype=I32, device=b_sorted.device)
    blen[tgt] = run_len.to(I32)
    blen = blen[:num_buckets]
    bstart = torch.cumsum(blen, 0, dtype=I32) - blen
    return bstart, blen


def inverse_permute(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[perm[i]] = vals[i]`` for ``perm`` an exact permutation of
    [0, n)."""
    out = torch.empty_like(vals)
    out[perm.long()] = vals
    return out


def is_sorted_ascending(keys: torch.Tensor, unsigned: bool = True) -> bool:
    """True iff ``keys`` is ascending (u32 order by default)."""
    if keys.shape[0] < 2:
        return True
    k = keys ^ SIGN if unsigned else keys
    return bool((k[1:] >= k[:-1]).all())
