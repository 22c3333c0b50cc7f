"""Runner of the micro-kernels P1-P9 (``ops/probes.py``) on one CUDA GPU.

Port of ``tools/mosaic_probe.py``: the nine capability and cost probes
behind a radix probe sort (rotate, in-tile scan, the matrix unit, permute,
masked store, copy granularity, the digit histogram), each at the original
probe's sizes.  Every case runs its kernel, compares the result with the
plain PyTorch version on the same tensors and prints OK or WRONG, the time
on CUDA events and ns per element.  Any WRONG exits non-zero.

    python3 -m hashjoin3d_tpu_torch.tools.mosaic_probe [-k FILTER]

``-k`` keeps the probes whose id or title contains FILTER.  The card and its
power limit print first.  Without a CUDA GPU it raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import probes
from ..utils.measure import bound_ms, card, events_ms, nbytes, require_cuda

class Probe(NamedTuple):
    title: str
    line: int     #: of the TPU probe in tools/mosaic_probe.py
    key: str      #: its wrapper's key in ``kernels.LAUNCHES``


PROBES = {
    "P1": Probe("roll: runtime whole-row roll along lanes", 72, "probe_roll"),
    "P2": Probe("rotate: per-row rotation", 103, "probe_rotate"),
    "P3": Probe("cumsum: along lanes and along rows", 142, "probe_cumsum"),
    "P4": Probe("mxu: one-hot permutation applied by a matrix product", 178,
                "probe_onehot_matmul"),
    "P5": Probe("permute: generic within-block permutation", 218,
                "probe_permute"),
    "P6": Probe("store: masked store at a runtime row offset", 269,
                "probe_masked_store"),
    "P7": Probe("dma: block copy in reversed block order", 305,
                "probe_block_copy"),
    "P8": Probe("dma-unaligned: 8-row copy from row offset 3", 349,
                "probe_row_copy"),
    "P9": Probe("onehot: 16-bin digit histogram per row", 382,
                "probe_digit_histogram"),
}


class Case(NamedTuple):
    probe: str                      #: "P1" .. "P9"
    label: str
    run: Callable                   #: the kernel's wrapper
    plain: Callable                 #: its plain PyTorch version
    n_elems: int
    inputs: tuple
    int8_ops: float = 0.0           #: u8 tensor-core operations (P4)
    library: Callable | None = None  #: one PyTorch call of the same function
    library_name: str = ""


def cases(dev, shrink: int = 0) -> list[Case]:
    """Every probe's cases on ``dev`` at the original sizes (``shrink``
    divides them by ``2^shrink``, for rehearsals off the card)."""
    rng = np.random.default_rng(0)
    n = 1 << (22 - shrink)
    rows = n // 128

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    x = t(np.arange(n).reshape(rows, 128))
    shifts = t(np.arange(rows) % 128)
    rot_idx = (torch.arange(128, device=dev) + shifts[:, None].long()) & 127
    vals = t(rng.integers(-1000, 1000, (rows, 128)))
    block = min(512, rows)
    x20 = t(rng.integers(0, 1 << 20, (rows, 128)))
    perm_mat = t(np.eye(128, dtype=np.int32)[::-1])
    digits = t(rng.integers(0, 16, (rows, 128)))
    out = [
        Case("P1", "roll(x, 5, axis=1)", lambda: probes.roll(x, 5),
             lambda: probes.roll_plain(x, 5), n, (x,),
             library=lambda: torch.roll(x, 5, 1),
             library_name="torch.roll"),
        Case("P2", "per-row rotate", lambda: probes.rotate(x, shifts),
             lambda: probes.rotate_plain(x, shifts), n, (x, shifts),
             library=lambda: torch.gather(x, 1, rot_idx),
             library_name="torch.gather"),
        *[Case("P3", f"cumsum axis={ax}",
               lambda ax=ax: probes.cumsum(vals, ax, block),
               lambda ax=ax: probes.cumsum_plain(vals, ax, block), n, (vals,),
               library=lambda ax=ax: (
                   torch.cumsum(vals, 1, dtype=torch.int32) if ax == 1
                   else torch.cumsum(vals.view(-1, block, 128), 1,
                                     dtype=torch.int32).view(vals.shape)),
               library_name="torch.cumsum")
          for ax in (1, 0)],
        Case("P4", "u8 byte planes (rows,128)@(128,128) one-hot",
             lambda: probes.onehot_matmul(x20, perm_mat),
             lambda: probes.onehot_matmul_plain(x20, perm_mat), n,
             (x20, perm_mat), int8_ops=3 * 2 * rows * 128 * 128,
             library=lambda: torch.matmul(x20.float(), perm_mat.float()),
             library_name="torch.matmul f32"),
    ]
    for C in (1024, 4096):
        xp = t(rng.integers(0, 1 << 30, (rows, 128)))
        p = t(rng.permutation(C))
        p64 = p.long()
        out.append(Case(
            "P5", f"generic permute C={C}",
            lambda xp=xp, p=p: probes.permute(xp, p),
            lambda xp=xp, p=p: probes.permute_plain(xp, p), n, (xp, p),
            library=lambda xp=xp, p64=p64, C=C: torch.index_select(
                xp.view(-1, C), 1, p64),
            library_name="torch.index_select"))
    xs = t(np.arange(1 << (20 - shrink)).reshape(-1, 128))
    out.append(Case("P6", "masked store, runtime row offset 8",
                    lambda: probes.masked_store(xs, 8),
                    lambda: probes.masked_store_plain(xs, 8), xs.numel(),
                    (xs[:8, :64],)))
    src = t(rng.integers(0, 1 << 30, 1 << (24 - shrink)))
    for B in (1024, 8192, 65536):
        if B > src.numel():
            continue
        out.append(Case(
            "P7", f"reversed block copy B={B} ({src.numel() // B} blocks)",
            lambda B=B: probes.block_copy(src, B),
            lambda B=B: probes.block_copy_plain(src, B), src.numel(), (src,),
            library=lambda: src.clone(), library_name="clone"))
    src8 = t(np.arange(max(1 << (18 - shrink), 16 * 128)).reshape(-1, 128))
    out.append(Case("P8", "8-row copy at row offset 3",
                    lambda: probes.row_copy(src8, 3),
                    lambda: probes.row_copy_plain(src8, 3), src8.numel(),
                    (src8[3:11],),
                    library=lambda: src8[3:11].clone(), library_name="clone"))
    out.append(Case("P9", "16-way digit histogram per row",
                    lambda: probes.digit_histogram(digits),
                    lambda: probes.digit_histogram_plain(digits), n,
                    (digits,)))
    return out


def run_case(c: Case, min_time: float) -> dict:
    """Kernel vs plain on the same tensors, then times; one result dict."""
    got, want = c.run(), c.plain()
    ok = got.shape == want.shape and torch.equal(got, want)
    err = (int((got.long() - want.long()).abs().max())
           if got.shape == want.shape else None)
    bound, bound_by = bound_ms(nbytes(*c.inputs, got), c.int8_ops)
    ms = events_ms(c.run, min_time)
    return dict(probe=c.probe, label=c.label, ok=ok, max_abs_err=err, ms=ms,
                ns_per_elem=ms * 1e6 / c.n_elems,
                plain_ms=events_ms(c.plain, min_time),
                library_ms=(events_ms(c.library, min_time) if c.library
                            else None),
                library_name=c.library_name, bound_ms=bound,
                bound_by=bound_by)


def run(dev, k: str, min_time: float, log) -> list[dict]:
    """Every case whose probe id or title contains ``k``: :func:`run_case`,
    one line to ``log`` each; the results in order."""
    results = []
    for c in cases(dev):
        title = PROBES[c.probe].title
        if k and k not in c.probe and k not in title:
            continue
        r = run_case(c, min_time)
        lib = (f"{r['library_name']} {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "no single call")
        log(f"  {c.probe} {c.label:44s} {'OK   ' if r['ok'] else 'WRONG'} "
            f"{r['ms']:9.4f} ms  {r['ns_per_elem']:8.4f} ns/elem  "
            f"plain {r['plain_ms']:.4f} ms  {lib}  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        results.append(r)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-k", default="", help="substring filter")
    ap.add_argument("--min-time", type=float, default=0.3)
    args = ap.parse_args(argv)
    dev = require_cuda()
    print(f"card: {card()}", flush=True)
    results = run(dev, args.k, args.min_time,
                  lambda line: print(line, flush=True))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
