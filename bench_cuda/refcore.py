"""Primitives of the plain references: the configurations' bucket hash and
the hash tables' chain orders, written from the 3D hash join artifact's
semantics (``util/hasht.hh``, ``ht_chaining.hh``, ``ht_nested.hh``) in
plain ``torch`` on int64 values.

- Bucket of key ``k``: ``murmur3_fmix32(k) % buckets``; on a mesh of
  ``shards`` ranks the owning shard is ``fmix32(fmix32(k)) % shards``, and
  a shard's table holds its rows in global row order.
- Chaining table: each bucket's chain is [first-inserted row, then the
  rest in reverse insertion order]; an early-exit probe compares up to its
  key's first row in chain order, a miss walks the whole chain.
- Nested (3D) table: one main node per distinct key, appended at its
  bucket's chain tail in first-occurrence order; a probe compares up to
  its key's main node, a miss walks the whole main chain.
"""

from __future__ import annotations

import torch

I64 = torch.int64
U32 = 0xFFFFFFFF
FMIX_C1, FMIX_C2 = 0x85EBCA6B, 0xC2B2AE35


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32): two 16-bit halves
    of ``c`` keep every product below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & U32


def fmix32(k: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer of u32 values held as int64."""
    x = k.to(I64) & U32
    x = x ^ (x >> 16)
    x = _mul32(x, FMIX_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, FMIX_C2)
    return x ^ (x >> 16)


def u32(col: torch.Tensor) -> torch.Tensor:
    """A key column (int32 carrier of u32 values) as int64 values."""
    return col.to(I64) & U32


def bucket(keys: torch.Tensor, buckets: int, shards: int = 1):
    """Each key's chain: its bucket, and on a mesh its shard's bucket as
    ``shard * buckets + bucket``."""
    b = fmix32(keys) % buckets
    if shards > 1:
        b = (fmix32(fmix32(keys)) % shards) * buckets + b
    return b


def _ranks(sorted_ids: torch.Tensor, counts: torch.Tensor):
    """0-based rank of each element of a sorted id stream within its run,
    and its run's length."""
    start = torch.cumsum(counts, 0) - counts
    idx = torch.arange(sorted_ids.shape[0], device=sorted_ids.device)
    return idx - start[sorted_ids], counts[sorted_ids]


def chaining_chains(keys: torch.Tensor, chains: torch.Tensor, n_chains: int,
                    domain: int):
    """A chaining table over ``keys`` (int64 values in [0, domain)) whose
    rows sit in chains ``chains``: ``(first_pos, rows_of_key, first_row,
    chain_len)`` -- each key's least 0-based chain position over its rows
    (-1 for an absent key), its row count, the row at that position, and
    each chain's length."""
    n = keys.shape[0]
    dev = keys.device
    order = torch.sort(chains, stable=True).indices
    counts = torch.bincount(chains, minlength=n_chains)
    rank, length = _ranks(chains[order], counts)
    pos = torch.empty(n, dtype=I64, device=dev)
    pos[order] = torch.where(rank == 0, 0, length - rank)
    first = torch.full((domain,), n, dtype=I64, device=dev)
    first.scatter_reduce_(0, keys, pos, "amin")
    rows = torch.bincount(keys, minlength=domain)
    at_first = pos == first[keys]
    first_row = torch.full((domain,), -1, dtype=I64, device=dev)
    first_row[keys[at_first]] = torch.nonzero(at_first).view(-1)
    return torch.where(rows > 0, first, -1), rows, first_row, counts


def nested_chains(keys: torch.Tensor, chain_of_key, n_chains: int,
                  domain: int):
    """A nested table over ``keys`` (int64 values in [0, domain)):
    ``(main_pos, rows_of_key, chain_len)`` -- each key's 0-based main-node
    position (-1 for an absent key), its row count, and each chain's
    number of main nodes.  ``chain_of_key`` maps key values to chains."""
    n = keys.shape[0]
    dev = keys.device
    first = torch.full((domain,), n, dtype=I64, device=dev)
    first.scatter_reduce_(0, keys, torch.arange(n, device=dev), "amin")
    gkey = torch.nonzero(first < n).view(-1)
    gchain = chain_of_key(gkey)
    order = torch.sort(gchain * (n + 1) + first[gkey]).indices
    counts = torch.bincount(gchain, minlength=n_chains)
    rank, _ = _ranks(gchain[order], counts)
    pos = torch.full((domain,), -1, dtype=I64, device=dev)
    pos[gkey[order]] = rank
    return pos, torch.bincount(keys, minlength=domain), counts


def probe_cmps(pos: torch.Tensor, chain_len: torch.Tensor,
               probe_keys: torch.Tensor, chain_of_key, domain: int,
               live=None):
    """``(hits, comparisons)`` of probing ``probe_keys`` (int64 values)
    against a table's positions: a hit compares ``pos + 1`` nodes, a miss
    its whole chain; ``live`` restricts the probes that run."""
    inside = (probe_keys >= 0) & (probe_keys < domain)
    p = torch.where(inside, pos[probe_keys.clamp(0, domain - 1)], -1)
    hit = p >= 0
    walk = torch.where(hit, p + 1, chain_len[chain_of_key(probe_keys)])
    if live is not None:
        hit, walk = hit & live, torch.where(live, walk, 0)
    return hit, int(hit.sum()), int(walk.sum())


def distinct_count(packed: torch.Tensor) -> tuple[int, int]:
    """``(distinct, duplicates)`` of an int64 stream."""
    if packed.numel() == 0:
        return 0, 0
    s = torch.sort(packed).values
    dup = int((s[1:] == s[:-1]).sum())
    return s.numel() - dup, dup
