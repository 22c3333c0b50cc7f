"""Pure-Python oracle reproducing the reference hash tables' exact semantics.

The port's own copy of ``tests/oracle.py`` (the port imports nothing from
``tests/``; ``tests/test_torch_fuzz.py`` holds the two equal).  It models
the *behavior* of ``ht_chaining.hh`` / ``ht_nested.hh`` / ``algebra.hh``
with plain lists (insertion simulation), giving ground truth for chain
orders, comparison counts and result multisets on arbitrary inputs.  Slow
(per-tuple): the fuzzers' small tier uses it, their large tier the native
host engine.
"""

from __future__ import annotations

def murmur32_py(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x


class ChainingOracle:
    """Simulates HtChaining1 insertion + AlgHashJoinProbe semantics."""

    def __init__(self, keys, num_buckets: int, hashfun=murmur32_py):
        self.nb = num_buckets
        self.hf = hashfun
        # bucket -> list of (row, key) in chain order
        self.buckets = {}
        for row, k in enumerate(int(v) for v in keys):
            b = self.hf(k) % num_buckets
            chain = self.buckets.setdefault(b, [])
            if not chain:
                chain.append((row, k))       # directory node
            else:
                chain.insert(1, (row, k))    # head-insert after dir entry
        self.keys = [int(v) for v in keys]

    def chain(self, b):
        return self.buckets.get(b, [])

    def probe(self, probe_keys, unique=False, predicate=None):
        """Returns (pairs, num_matches, num_cmps). pairs = (probe_row, build_row).

        ``predicate(probe_row, build_row) -> bool`` replaces the key-equality
        joinpred INSIDE the walk, exactly as the reference evaluates it
        (algebra.hh:645-648): a chain node matches iff its hashvalue equals
        the probe's AND the predicate passes; IsBuildKeyUnique breaks there.
        """
        pairs = []
        matches = 0
        cmps = 0
        for p, k in enumerate(int(v) for v in probe_keys):
            b = self.hf(k) % self.nb
            chain = self.chain(b)
            if not chain:
                continue
            for row, bk in chain:
                cmps += 1
                if predicate is None:
                    ok = bk == k
                else:
                    ok = self.hf(bk) == self.hf(k) and predicate(p, row)
                if ok:
                    pairs.append((p, row))
                    matches += 1
                    if unique:
                        break
        return pairs, matches, cmps

    def stats(self):
        lens = [len(self.chain(b)) for b in range(self.nb)]
        nonempty = [l for l in lens if l > 0]
        distinct_hashes = len({self.hf(k) for k in self.keys})
        return dict(
            num_buckets=self.nb,
            num_empty=sum(1 for l in lens if l == 0),
            num_entries=len(self.keys),
            num_distinct=distinct_hashes,
            cc0=lens,
            cc1=nonempty,
        )


class NestedOracle:
    """Simulates HtNested1 insertion + AlgNestJoinProbe/AlgUnnestHt semantics."""

    def __init__(self, keys, num_buckets: int, hashfun=murmur32_py):
        self.nb = num_buckets
        self.hf = hashfun
        # bucket -> list of mains; main = dict(key, first_row, subrows list)
        self.buckets = {}
        for row, k in enumerate(int(v) for v in keys):
            b = self.hf(k) % num_buckets
            mains = self.buckets.setdefault(b, [])
            for m in mains:
                if m["key"] == k:
                    m["subrows"].insert(0, row)  # head-insert into subchain
                    break
            else:
                mains.append(dict(key=k, first_row=row, subrows=[]))
        self.keys = [int(v) for v in keys]

    def probe(self, probe_keys, predicate=None):
        """Returns (nested, num_matches, num_cmps); nested = (probe_row, main).

        ``predicate(probe_row, group_first_row) -> bool`` replaces the
        key-equality joinpred in the main-chain walk (ht_nested.hh:366-375):
        evaluated once per hashvalue-equal main node against the group's
        FIRST tuple; the first passing node matches and the walk stops.
        """
        nested = []
        matches = 0
        cmps = 0
        for p, k in enumerate(int(v) for v in probe_keys):
            b = self.hf(k) % self.nb
            mains = self.buckets.get(b, [])
            for m in mains:
                cmps += 1
                if predicate is None:
                    ok = m["key"] == k
                else:
                    ok = (self.hf(m["key"]) == self.hf(k)
                          and predicate(p, m["first_row"]))
                if ok:
                    nested.append((p, m))
                    matches += 1
                    break
        return nested, matches, cmps

    @staticmethod
    def unnest(nested):
        """Expansion order: MainNode row first, then subchain (LIFO)."""
        out = []
        for p, m in nested:
            out.append((p, m["first_row"]))
            for r in m["subrows"]:
                out.append((p, r))
        return out

    def stats(self):
        lens = [len(self.buckets.get(b, [])) for b in range(self.nb)]
        nonempty = [l for l in lens if l > 0]
        n_distinct = sum(lens)
        return dict(
            num_buckets=self.nb,
            num_empty=sum(1 for l in lens if l == 0),
            num_entries=len(self.keys),
            num_distinct=n_distinct,
            cc0=lens,
            cc1=nonempty,
        )
