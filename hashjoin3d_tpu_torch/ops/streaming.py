"""Out-of-core probe streaming: probe a key column that never has to fit in
device memory.

Port of ``hashjoin3d_tpu/ops/streaming.py`` (``stream_probe_chaining``,
``stream_probe_nested``).  The build table stays resident on its device
while the probe column streams from host memory (a numpy array or a
``np.memmap`` of any length) in fixed chunks, each probed by the windowed
strand of the table's layout:

* dense-direct tables: :func:`~.strands_windowed.direct_probe_strand_sorted`;
* ``key_direct`` tables: the key_direct chaining / nested strands;
* everything else (u64, composite and sparse-domain keys): the merged
  strands.

On CUDA the chunk loop double-buffers through two pinned host staging
buffers and a side ``torch.cuda.Stream``.  A worker thread stages chunk
i+1 while the calling thread issues chunk i's probe and waits on its host
reads: it copies the chunk into pinned memory (numpy's copy releases the
GIL), then issues its upload ``non_blocking`` on the side stream.  Events order each
upload before its probe, and each staging buffer's reuse after the probe
(device buffer) or the upload (host buffer) that last read it.  Counters
accumulate as device int64 tensors and are read once at the end; result
pairs come back per chunk only under ``collect_pairs``.  On the CPU the
same loop runs on the calling thread without streams: that is the plain
version the tests hold against the JAX package.

Device residency is the table, two chunk buffers and one chunk's strand
working set (``out_per_chunk`` expansion slots), whatever the column's
length.

The JAX package pads the tail chunk to its static shape with the all-ones
key and subtracts the pad rows' bucket walks again.  The port runs eagerly
and probes a short tail chunk as it is: no pad key, no correction, and the
all-ones key is an ordinary key here.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .layout import I32, I64


class ChunkStager:
    """A host key column as carrier chunks on ``device``.

    ``stage(i)`` starts staging chunk i into one of two rotating buffers:
    on CUDA a worker thread copies it into pinned host memory and issues
    its upload on the side stream; on the CPU it is copied at once.
    ``take(i)`` waits for that staging (a failed copy raises there) and
    returns the chunk's carrier, ordered after its upload on the current
    stream; ``release(i)`` marks the chunk's buffer free once the work
    queued so far on the current stream is done.  So chunk i+1 may be
    staged while chunk i is in use.  ``host_s`` sums the wall time of the
    copies into the staging buffers (a ``np.memmap`` column pays its reads
    there).  ``close()`` (or leaving a ``with`` block) ends the worker
    thread."""

    def __init__(self, keys: np.ndarray, chunk_size: int, wide: bool,
                 device: torch.device):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.keys = keys
        self.n = keys.shape[0]
        self.chunk_size = chunk_size
        self.n_chunks = -(-self.n // chunk_size)
        self.dtype = I64 if wide else I32
        self.host_dtype = np.uint64 if wide else np.uint32
        self.device = device
        self.host_s = 0.0
        size = min(chunk_size, self.n)
        self.cuda = device.type == "cuda"
        self.pending = [None, None]
        if self.cuda:
            self.side = torch.cuda.Stream(device)
            self.host = [torch.empty(size, dtype=self.dtype,
                                     pin_memory=True) for _ in range(2)]
            self.dbuf = [torch.empty(size, dtype=self.dtype, device=device)
                         for _ in range(2)]
            for b in self.dbuf:
                b.record_stream(self.side)
            self.uploaded = [torch.cuda.Event() for _ in range(2)]
            self.freed = [torch.cuda.Event() for _ in range(2)]
            self.stager = ThreadPoolExecutor(1)
        else:
            self.host = [torch.empty(size, dtype=self.dtype)
                         for _ in range(2)]

    def __enter__(self) -> "ChunkStager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def bounds(self, i: int) -> tuple[int, int]:
        lo = i * self.chunk_size
        return lo, min(lo + self.chunk_size, self.n)

    def _fill(self, buf: torch.Tensor, lo: int, hi: int) -> None:
        src = self.keys[lo:hi]
        if src.dtype.itemsize < 4:  # narrower keys take their u32 bits
            src = src.astype(np.uint32)
        t0 = time.perf_counter()
        # a signed column keeps its bits; u32 into u64 zero-extends
        np.copyto(buf.numpy().view(self.host_dtype)[:hi - lo],
                  src.view(src.dtype.str.replace("i", "u")),
                  casting="unsafe")
        self.host_s += time.perf_counter() - t0

    def _stage_cuda(self, i: int) -> None:
        lo, hi = self.bounds(i)
        b = i % 2
        # the pinned buffer's last upload (chunk i - 2) must be done
        self.uploaded[b].synchronize()
        self._fill(self.host[b], lo, hi)
        with torch.cuda.stream(self.side):
            # ... and the device buffer's last probe (chunk i - 2)
            self.side.wait_event(self.freed[b])
            self.dbuf[b][:hi - lo].copy_(self.host[b][:hi - lo],
                                         non_blocking=True)
            self.uploaded[b].record(self.side)

    def stage(self, i: int) -> None:
        if self.cuda:
            self.pending[i % 2] = self.stager.submit(self._stage_cuda, i)
        else:
            self._fill(self.host[i % 2], *self.bounds(i))

    def take(self, i: int) -> torch.Tensor:
        lo, hi = self.bounds(i)
        b = i % 2
        if not self.cuda:
            return self.host[b][:hi - lo]
        self.pending[b].result()
        torch.cuda.current_stream(self.device).wait_event(self.uploaded[b])
        return self.dbuf[b][:hi - lo]

    def release(self, i: int) -> None:
        if self.cuda:
            self.freed[i % 2].record(torch.cuda.current_stream(self.device))

    def close(self) -> None:
        """End the worker thread and order the side stream's work before
        the current stream's."""
        if self.cuda:
            self.stager.shutdown()
            torch.cuda.current_stream(self.device).wait_stream(self.side)


def _host_column(probe_keys_host, wide: bool) -> np.ndarray:
    pk = np.asarray(probe_keys_host)
    if pk.ndim != 1 or pk.dtype.kind not in "iu":
        raise TypeError(f"expected a 1-D integer key column, got "
                        f"{pk.dtype}{list(pk.shape)}")
    if pk.dtype.itemsize == 8 and not wide:
        raise ValueError("64-bit probe keys against a u32 table would "
                         "truncate; build the table from u64 keys")
    return pk


def _stream_chunks(table, probe_keys_host, chunk_size: int, probe_one,
                   collect_pairs: bool):
    """The shared chunk loop; returns ``(matches, cmps, emitted, pairs)``.
    ``probe_one(chunk) -> (probe_row, build_row, matches, cmps, emitted)``
    on one chunk's carrier."""
    wide = table.keys.dtype == I64
    device = table.keys.device
    pk = _host_column(probe_keys_host, wide)
    pairs = []
    if pk.shape[0] == 0:
        return 0, 0, 0, pairs
    acc = torch.zeros(3, dtype=I64, device=device)
    with ChunkStager(pk, chunk_size, wide, device) as st:
        st.stage(0)
        for i in range(st.n_chunks):
            if i + 1 < st.n_chunks:
                st.stage(i + 1)  # copies and uploads while this chunk probes
            prow, brow, m, c, tot = probe_one(st.take(i))
            acc += torch.stack([m.to(I64), c.to(I64), tot.to(I64)])
            st.release(i)
            if collect_pairs:
                v = prow >= 0
                pairs.append((prow[v].cpu().numpy().astype(np.int64)
                              + st.bounds(i)[0],
                              brow[v].cpu().numpy()))
    matches, cmps, emitted = acc.tolist()
    if collect_pairs and sum(p[0].size for p in pairs) < emitted:
        raise ValueError(
            f"a chunk overflowed out_per_chunk: emitted {emitted} in total "
            "but materialized fewer; raise out_per_chunk or lower "
            "chunk_size")
    return matches, cmps, emitted, pairs


def chunk_probe_chaining(table, unique: bool = True,
                         out_size: int = 1 << 24):
    """The strand one chunk of a chaining table's probe column takes:
    ``probe_one(chunk) -> (probe_row, build_row, matches, cmps, emitted)``
    on a carrier on the table's device.  Dense-direct tables take the
    positional strand (``unique=False`` needs ``full_chain_index``),
    ``key_direct`` tables the key_direct strand, everything else (u64,
    composite, sparse domains) the merged strand; those two expand into
    ``out_size`` slots."""
    from .strands_windowed import (direct_probe_strand_sorted,
                                   keydirect_chaining_strand_sorted,
                                   merged_chaining_strand_sorted)

    if table.direct is not None:
        if not unique and table.chain_by_key is None:
            raise ValueError(
                "stream_probe_chaining(unique=False) on a dense-direct "
                "table counts full chain walks per probe: build with "
                "full_chain_index=True")

        def probe_one(chunk):
            o = direct_probe_strand_sorted(table, chunk, unique=unique)
            return (o["probe_row"], o["build_row"], o["c_htProbe"],
                    o["c_htProbeCmp"], o["c_htProbe"])
        return probe_one
    strand = (keydirect_chaining_strand_sorted
              if table.key_direct is not None
              else merged_chaining_strand_sorted)

    def probe_one(chunk):
        o = strand(table, chunk, out_size, unique=unique)
        return (o["probe_row"], o["build_row"], o["c_htProbe"],
                o["c_htProbeCmp"], o["total"])
    return probe_one


def chunk_probe_nested(table, out_size: int = 1 << 24):
    """:func:`chunk_probe_chaining` for a nested (3D) table: probe and
    unnest, ``emitted`` the unnest count."""
    from .strands_windowed import (direct_probe_strand_sorted,
                                   keydirect_nested_strand_sorted,
                                   merged_nested_strand_sorted)

    if table.direct is not None:
        def probe_one(chunk):
            o = direct_probe_strand_sorted(table, chunk, unique=True,
                                           nested=True)
            return (o["probe_row"], o["build_row"], o["c_htProbe"],
                    o["c_htProbeCmp"], o["c_unnest"])
        return probe_one
    strand = (keydirect_nested_strand_sorted
              if table.key_direct is not None
              else merged_nested_strand_sorted)

    def probe_one(chunk):
        o = strand(table, chunk, out_size)
        return (o["probe_row"], o["build_row"], o["c_htProbe"],
                o["c_htProbeCmp"], o["c_unnest"])
    return probe_one


def stream_probe_chaining(table, probe_keys_host, chunk_size: int = 1 << 22,
                          unique: bool = True, collect_pairs: bool = False,
                          out_per_chunk: int | None = None):
    """Probe a device-resident chaining table with a host-resident key
    column of any size (numpy array or memmap), in overlapped chunks.

    Returns ``(num_matches, num_cmps, pairs)``; ``pairs`` is a list of
    per-chunk ``(probe_row_global, build_row)`` numpy arrays (hits only)
    under ``collect_pairs``, else ``[]``.  Counters are bit-equal to a
    whole-column probe and the pairs equal its pairs as a multiset.

    Each chunk takes :func:`chunk_probe_chaining`'s strand: dense-direct
    tables the positional one, ``key_direct`` tables the key_direct one,
    everything else (u64, composite, sparse domains) the merged one.
    Those two expand matches into ``out_per_chunk`` slots (default
    ``4 * chunk_size``); under ``collect_pairs`` a chunk that emits more
    raises.
    """
    probe_one = chunk_probe_chaining(table, unique,
                                     out_per_chunk or 4 * chunk_size)
    matches, cmps, _, pairs = _stream_chunks(table, probe_keys_host,
                                             chunk_size, probe_one,
                                             collect_pairs)
    return matches, cmps, pairs


def stream_probe_nested(table, probe_keys_host, chunk_size: int = 1 << 22,
                        collect_pairs: bool = False,
                        out_per_chunk: int | None = None):
    """Probe + unnest a device-resident nested (3D) table with a
    host-resident key column of any size, in overlapped chunks.

    Returns ``(num_matches, num_cmps, num_unnested, pairs)``; counters are
    bit-equal to a whole-column ``probe_nested`` + ``unnest``.
    Dense-direct tables take the positional strand, ``key_direct`` tables
    the key_direct strand, u64 and sparse-domain tables the merged strand;
    ``out_per_chunk`` (default ``4 * chunk_size``) bounds one chunk's
    expansion under ``collect_pairs``.
    """
    probe_one = chunk_probe_nested(table, out_per_chunk or 4 * chunk_size)
    return _stream_chunks(table, probe_keys_host, chunk_size, probe_one,
                          collect_pairs)
