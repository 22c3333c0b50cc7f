"""Composable physical algebra over columnar relations.

Port of ``hashjoin3d_tpu/models/algebra.py``, the library-facing query API
re-designed from the reference's push-based algebra (``algebra.hh:14-34``):
the operators Scan, Selection, DynSelection, HashJoinBuild/Probe
(chaining), NestJoinBuild/Probe (3D), UnnestHt and Top, wired into the
same build and probe strands, each a whole-column transform over a
:class:`Batch`.  A plan runs its build strands, then its probe strand;
every operator keeps the reference's counters (``count``, inclusive
runtime, ``runs``; :func:`print_strand`, :func:`get_runtime_excl`,
``algebra.hh:127-162``).

Columns and carriers.  :class:`Relation` takes host (numpy) columns and
puts them on its device: a u32 column rides as the int32 carrier, a u64
one as the int64 carrier (``ops/layout.py``), and each batch remembers
every column's host dtype.  So that a u32 value at or above 2^31 compares
as numpy compares it:

  * predicates (``lambda cols: cols["b"] < 40``) and residual predicates
    see the *values*: a u32 column widened to int64, every other column as
    stored (a u64 column stays on its int64 carrier);
  * key extractors (a column name, or ``lambda cols: ...``) see and return
    the *carriers*: the tables hash the key's bits;
  * :meth:`Batch.to_numpy` and :class:`AlgTop`'s printed rows give the
    columns back in their host dtypes.

The interpreted strand reads each operator's count back as it runs (one
read or more an operator).  :func:`compile_strand` runs a probe strand
with static output capacities and reads every counter back in one
transfer at its end.  An operator's timer synchronises the device at its
start and end, so its runtime covers its device work.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.chaining import build_chaining, materialize_chaining_join, \
    probe_chaining
from ..ops.layout import I32, I64, resolve_device, u32_to_i64
from ..ops.nested import NestedBatch, build_nested, probe_nested, unnest


def _device_column(a: np.ndarray, device) -> torch.Tensor:
    """A host column on ``device``: u32 as the int32 carrier, u64 as the
    int64 one, every other dtype as itself."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.bool_ or a.dtype.kind == "u":
        raise TypeError(f"unsupported column dtype {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def _sync() -> None:
    """Wait for the CUDA device, if this process has touched one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- storage ------------------------------------------------------------------

class Relation:
    """Columnar relation: named equal-length columns on one device
    (``RelationRS``, ``algebra.hh:98-106``).  Host columns come in as
    numpy arrays; ``device`` defaults to CUDA and raises without one."""

    def __init__(self, device="cuda", **columns):
        lens = {len(v) for v in columns.values()}
        if len(lens) != 1:
            raise ValueError("columns must have equal length")
        self.device = resolve_device(device)
        host = {k: np.asarray(v) for k, v in columns.items()}
        self.dtypes = {k: v.dtype for k, v in host.items()}
        self.columns = {k: _device_column(v, self.device)
                        for k, v in host.items()}
        self.card = lens.pop()

    def __repr__(self):
        return f"Relation({', '.join(self.columns)}; card={self.card})"


@dataclass
class Nest:
    """One nested attribute: each row's group id in a 3D table, the
    vectorized ``MainNode*`` of a nested tuple (``algebra.hh:404-473``)."""

    group: torch.Tensor    # i32[n] group id per row (valid where batch.mask)
    table: object          # the NestedTable owning the groups
    build_batch: "Batch"   # the build side's batch (for unnest's columns)


@dataclass
class Batch:
    """A whole-column tuple stream: carrier columns, their host dtypes, a
    liveness mask (``None``: every row live) and named nests."""

    columns: dict
    mask: torch.Tensor | None = None
    nests: dict = field(default_factory=dict)
    dtypes: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    def live_count(self) -> int:
        if self.mask is None:
            return self.n
        return int(self.mask.sum())

    def values(self) -> dict:
        """The columns as predicates see them: a u32 column widened to
        its unsigned int64 values, every other column as stored."""
        return {k: u32_to_i64(v) if self.dtypes.get(k) == np.uint32 else v
                for k, v in self.columns.items()}

    def to_numpy(self) -> dict:
        """The columns on the host in their host dtypes (a u32 column as
        numpy uint32, a u64 one as uint64)."""
        out = {}
        for k, v in self.columns.items():
            a = v.cpu().numpy()
            dt = self.dtypes.get(k)
            out[k] = a.view(dt) if dt is not None and \
                dt.itemsize == a.dtype.itemsize else a
        return out


def _key_fn(key):
    return key if callable(key) else (lambda cols: cols[key])


def _prefixed(dtypes: dict, prefix: str) -> dict:
    return {prefix + k: v for k, v in dtypes.items()}


def _pow2(count: int) -> int:
    """The output buffer of ``count`` rows: its power-of-two ceiling."""
    return max(1, 1 << (int(count) - 1).bit_length())


@dataclass
class GlobStat0:
    """Global plan-state knobs (``algebra.hh:118-123``; unused there too)."""

    ht_num_buckets: int = 0
    ht_rsv_log2_chunksize_main: int = 0
    ht_rsv_log2_chunksize_sub: int = 0
    ht_rsv_log2_chunksize: int = 0


# -- operator base ------------------------------------------------------------

class AlgBase:
    """Counter and timer surface of every operator (``algebra.hh:166-200``).
    The timer synchronises the device at its start and its end."""

    def __init__(self, name):
        self._name = name
        self._count = 0
        self._ok = True
        self._runs = 0
        self._t0 = self._t1 = 0.0

    def reset(self):
        self._count = 0
        self._ok = True
        self._runs += 1
        _sync()
        self._t0 = time.perf_counter()

    def stop_timer(self):
        _sync()
        self._t1 = time.perf_counter()

    @property
    def name(self):
        return self._name

    def count(self):
        return self._count

    def ok(self):
        return self._ok

    def runs(self):
        return self._runs

    def runtime(self) -> float:
        """Inclusive runtime in seconds (downstream operators included, as
        the reference's, ``algebra.hh:186-189``)."""
        return self._t1 - self._t0

    def consumer(self):
        return getattr(self, "_consumer", None)


def get_runtime_excl(op: AlgBase) -> float:
    """Approximate exclusive runtime: the inclusive one minus the
    consumer's (``algebra.hh:127-138``)."""
    c = op.consumer()
    return op.runtime() - (c.runtime() if c is not None else 0.0)


def print_strand(op, indent=0, out=None):
    """Top-down operator dump: name|count|excl-runtime|runs
    (``algebra.hh:148-162``)."""
    out = out or sys.stdout
    c = op.consumer()
    if c is not None:
        print_strand(c, indent, out)
    out.write("  " * indent +
              f"{op.name}|{op.count()}|{get_runtime_excl(op)*1e3:.3f} ms|"
              f"{op.runs()}\n")


# -- sinks and sources --------------------------------------------------------

class AlgTop(AlgBase):
    """Plan root: counts (and optionally prints) the result tuples
    (``algebra.hh:204-243``) and keeps the final batch.  Printed rows hold
    host values (:meth:`Batch.to_numpy`)."""

    def __init__(self, out=None, print_result=False, print_fun=None):
        super().__init__("AlgTop")
        self._out = out or sys.stdout
        self.print_result = print_result
        self._print_fun = print_fun or (lambda row, o: o.write(repr(row)))
        self.result: Batch | None = None

    def consume(self, batch: Batch, gs):
        self.reset()
        self.result = batch
        self._count = batch.live_count()
        if self.print_result and self.runs() == 1:
            cols = batch.to_numpy()
            mask = (batch.mask.cpu().numpy() if batch.mask is not None
                    else np.ones(batch.n, bool))
            for i in np.nonzero(mask)[0]:
                self._print_fun({k: v[i].item() for k, v in cols.items()},
                                self._out)
                self._out.write("\n")
        self.stop_timer()


class AlgScan(AlgBase):
    """Producer: streams a relation into its consumer as one batch
    (``algebra.hh:247-275``)."""

    def __init__(self, consumer, relation: Relation):
        super().__init__("AlgScan")
        self._consumer = consumer
        self._relation = relation

    def batch(self) -> Batch:
        rel = self._relation
        return Batch(dict(rel.columns), dtypes=dict(rel.dtypes))

    def run(self, gs=None):
        self.reset()
        self._count = self._relation.card
        self._consumer.consume(self.batch(), gs)
        self.stop_timer()


# -- filters ------------------------------------------------------------------

class AlgSelection(AlgBase):
    """Static-predicate filter (``algebra.hh:279-315``): a callable over
    the column values (:meth:`Batch.values`), fixed when the plan is
    built."""

    def __init__(self, consumer, predicate):
        super().__init__("AlgSelection")
        self._consumer = consumer
        self._pred = predicate

    def select(self, batch: Batch) -> Batch:
        sel = self._pred(batch.values())
        mask = sel if batch.mask is None else sel & batch.mask
        return Batch(batch.columns, mask, dict(batch.nests), batch.dtypes)

    def consume(self, batch: Batch, gs):
        self.reset()
        out = self.select(batch)
        self._count = out.live_count()
        self._consumer.consume(out, gs)
        self.stop_timer()


class AlgDynSelection(AlgSelection):
    """Runtime-predicate filter (``algebra.hh:319-358``); the same columnar
    semantics, the predicate object supplied per instance."""

    def __init__(self, consumer, predicate):
        super().__init__(consumer, predicate)
        self._name = "AlgDynSelection"


# -- chaining hash join -------------------------------------------------------

class AlgHashJoinBuild(AlgBase):
    """Chaining-table build (``algebra.hh:556-586``): the clarity build
    (``ops.chaining.build_chaining``) over the live rows."""

    def __init__(self, key, num_buckets: int, relation: Relation = None,
                 hashfun="murmur"):
        super().__init__("AlgHashJoinBuild")
        self._key = _key_fn(key)
        self.num_buckets = num_buckets
        self.hashfun = hashfun  # pluggable Thashfun (ht_chaining.hh:236-248)
        self.build_batch: Batch | None = None
        self.table = None

    def consume(self, batch: Batch, gs):
        self.reset()
        self.table = build_chaining(self._key(batch.columns),
                                    self.num_buckets, valid=batch.mask,
                                    hashfun=self.hashfun)
        self.build_batch = batch
        self._count = batch.live_count()
        self.stop_timer()

    def hashtable(self):
        return self.table

    def clear_ht(self):
        self.table = None


def _join_batch(probe: Batch, build: Batch, pr, br, valid, lp, rp,
                nests: dict) -> Batch:
    """The output batch of a join: the probe side's columns at ``pr``
    prefixed ``lp``, the build side's at ``br`` prefixed ``rp``."""
    pr, br = pr.long(), br.long()
    cols = {lp + k: v[pr] for k, v in probe.columns.items()}
    cols.update({rp + k: v[br] for k, v in build.columns.items()})
    dtypes = _prefixed(probe.dtypes, lp)
    dtypes.update(_prefixed(build.dtypes, rp))
    return Batch(cols, valid, nests, dtypes)


def _apply_residual(residual, probe: Batch, build: Batch, pr, br, valid):
    """``valid`` and'ed with the residual predicate over the values of each
    pair's columns (``concepts.hh:49-56``)."""
    if residual is None:
        return valid
    pr, br = pr.long(), br.long()
    pcols = {k: v[pr] for k, v in probe.values().items()}
    bcols = {k: v[br] for k, v in build.values().items()}
    return valid & torch.as_tensor(residual(pcols, bcols), dtype=torch.bool)


class AlgHashJoinProbe(AlgBase):
    """Chaining-table probe (``algebra.hh:589-672``): one output row per
    match, the columns prefixed ``l.`` / ``r.`` (the concat function).
    ``unique`` is IsBuildKeyUnique.  ``residual(probe_cols, build_cols)``
    filters the matched pairs after the hash match (the reference tests it
    inside the chain walk, ``algebra.hh:647-648``): ``count`` counts the
    surviving pairs, ``num_cmps`` the chain comparisons."""

    def __init__(self, consumer, build_op: AlgHashJoinBuild, key,
                 unique: bool = False, lprefix: str = "l.",
                 rprefix: str = "r.", residual=None):
        super().__init__("AlgHashJoinProbe")
        self._consumer = consumer
        self._build = build_op
        self._key = _key_fn(key)
        self._unique = unique
        self._lp, self._rp = lprefix, rprefix
        self._residual = residual
        self.num_cmps = 0
        #: rows the last run expanded to (before the residual)
        self.expanded = 0

    def probe(self, batch: Batch, table):
        return probe_chaining(table, self._key(batch.columns),
                              unique=self._unique, mask=batch.mask)

    def join(self, batch: Batch, table, res, out_size: int,
             sync_free: bool):
        """``(output batch, expansion total)`` of probe result ``res``."""
        prow, brow, valid, total = materialize_chaining_join(
            table, res, out_size, unique=self._unique, sync_free=sync_free)
        pr, br = torch.clamp(prow, min=0), torch.clamp(brow, min=0)
        build = self._build.build_batch
        valid = _apply_residual(self._residual, batch, build, pr, br, valid)
        nests = {name: Nest(nst.group[pr.long()], nst.table, nst.build_batch)
                 for name, nst in batch.nests.items()}
        out = _join_batch(batch, build, pr, br, valid, self._lp, self._rp,
                          nests)
        return out, total

    def consume(self, batch: Batch, gs):
        self.reset()
        table = self._build.hashtable()
        res = self.probe(batch, table)
        self._count = self.expanded = int(res.num_matches)
        self.num_cmps = int(res.num_cmps)
        out, _ = self.join(batch, table, res, _pow2(self._count), False)
        if self._residual is not None:
            self._count = out.live_count()
        self._consumer.consume(out, gs)
        self.stop_timer()


# -- 3D (nested) hash join ----------------------------------------------------

class AlgNestJoinBuild(AlgBase):
    """3D-table build (``algebra.hh:362-401``): the clarity build
    (``ops.nested.build_nested``) over the live rows."""

    def __init__(self, key, num_buckets: int, hashfun="murmur"):
        super().__init__("AlgNestJoinBuild")
        self._key = _key_fn(key)
        self.num_buckets = num_buckets
        self.hashfun = hashfun  # pluggable Thashfun (ht_nested.hh:355-363)
        self.build_batch: Batch | None = None
        self.table = None

    def consume(self, batch: Batch, gs):
        self.reset()
        self.table = build_nested(self._key(batch.columns), self.num_buckets,
                                  valid=batch.mask, hashfun=self.hashfun)
        self.build_batch = batch
        self._count = batch.live_count()
        self.stop_timer()

    def hashtable(self):
        return self.table

    def clear_ht(self):
        self.table = None


class AlgNestJoinProbe(AlgBase):
    """3D-table probe (``algebra.hh:404-473``): at most one *nested* tuple
    a probe row; the output keeps the probe columns and adds the nest
    ``nest`` (each row's matched group)."""

    def __init__(self, consumer, build_op: AlgNestJoinBuild, key,
                 nest: str = "nest"):
        super().__init__("AlgNestJoinProbe")
        self._consumer = consumer
        self._build = build_op
        self._key = _key_fn(key)
        self._nest = nest
        self.num_cmps = 0

    def join(self, batch: Batch, table):
        """``(output batch, probe result)``."""
        res = probe_nested(table, self._key(batch.columns), mask=batch.mask)
        nests = dict(batch.nests)
        nests[self._nest] = Nest(res.g, table, self._build.build_batch)
        return Batch(batch.columns, res.hit, nests, batch.dtypes), res

    def consume(self, batch: Batch, gs):
        self.reset()
        out, res = self.join(batch, self._build.hashtable())
        self._count = int(res.num_matches)
        self.num_cmps = int(res.num_cmps)
        self._consumer.consume(out, gs)
        self.stop_timer()


class AlgUnnestHt(AlgBase):
    """Unnest (``algebra.hh:476-552``): each nested tuple becomes one
    output row per duplicate, [MainNode row, then the SubNodes LIFO].
    ``residual`` filters the unnested pairs (nested probes emit group
    handles, so a pair predicate applies here)."""

    def __init__(self, consumer, nest: str = "nest", lprefix: str = "",
                 rprefix: str = "r.", residual=None):
        super().__init__("AlgUnnest")
        self._consumer = consumer
        self._nest = nest
        self._lp, self._rp = lprefix, rprefix
        self._residual = residual
        #: rows the last run expanded to (before the residual)
        self.expanded = 0

    def group_lens(self, batch: Batch):
        """``(nest, live mask, each row's group length or 0)``."""
        nest = batch.nests[self._nest]
        mask = (batch.mask if batch.mask is not None else
                torch.ones(batch.n, dtype=torch.bool,
                           device=nest.group.device))
        glen = torch.where(mask, nest.table.groups.group_len[
            nest.group.long()], 0)
        return nest, mask, glen

    def expand(self, batch: Batch, lens, out_size: int):
        """``(output batch, unnest total)`` of ``lens``, the batch's
        :meth:`group_lens`."""
        nest, mask, glen = lens
        zero = torch.zeros((), dtype=I64, device=glen.device)
        nb = NestedBatch(
            probe_row=torch.arange(batch.n, dtype=I32, device=glen.device),
            g=nest.group, hit=mask, group_len=glen, num_matches=zero,
            num_cmps=zero)
        prow, brow, valid, total = unnest(nest.table, nb, out_size)
        pr, br = torch.clamp(prow, min=0), torch.clamp(brow, min=0)
        valid = _apply_residual(self._residual, batch, nest.build_batch, pr,
                                br, valid)
        # the other nests stay nested: their group ids follow the rows
        nests = {name: Nest(nst.group[pr.long()], nst.table, nst.build_batch)
                 for name, nst in batch.nests.items() if name != self._nest}
        out = _join_batch(batch, nest.build_batch, pr, br, valid, self._lp,
                          self._rp, nests)
        return out, total

    def consume(self, batch: Batch, gs):
        self.reset()
        lens = self.group_lens(batch)
        out, total = self.expand(batch, lens,
                                 _pow2(int(lens[2].to(I64).sum())))
        self._count = self.expanded = int(total)
        if self._residual is not None:
            self._count = out.live_count()
        self._consumer.consume(out, gs)
        self.stop_timer()


# -- strand fusion ------------------------------------------------------------

def _strand_ops(scan: AlgScan) -> list:
    """The operators from a scan's consumer down to (and with) AlgTop."""
    ops = []
    op = scan._consumer
    while op is not None:
        ops.append(op)
        op = op.consumer()
    return ops


def compile_strand(scan: AlgScan, out_sizes: dict | None = None,
                   growth: int = 2):
    """A probe strand with static output capacities, run with no operator
    count read between its operators.

    The interpreted strand reads each expanding operator's count back to
    size its output.  Here every expanding operator (hash-join probe,
    unnest) gets a static capacity, from, in this order: ``out_sizes[op]``,
    the rows it expanded to in an earlier interpreted run (its count, before
    a residual predicate) rounded up to a power of two ("profile, then
    fuse"), or ``growth`` times its input size.  Returns a zero-argument
    callable that runs the strand, selects ``materialize_chaining_join``'s
    layout on the device, fills every operator's counters from one
    transfer of all of them at the end, and returns the AlgTop.  It
    raises ``ValueError`` when an operator's true total exceeds its
    capacity (the counters stay exact; rows would have been cut).  The
    build strands run before, interpreted; their tables are read when the
    callable runs.  What remains between the operators is the windowed
    lookup's route read (``safe_lookup``, one a call) and the dense-direct
    probes' miss check.
    """
    ops = _strand_ops(scan)
    if not ops or not isinstance(ops[-1], AlgTop):
        raise ValueError("strand must end in AlgTop")
    out_sizes = out_sizes or {}

    def capacity(op, n_in):
        if op in out_sizes:
            return max(int(out_sizes[op]), 1)
        if op.expanded > 0:
            return _pow2(op.expanded)
        return max(1, growth * n_in)

    caps = {}
    n = scan._relation.card
    for op in ops:
        if isinstance(op, (AlgHashJoinProbe, AlgUnnestHt)):
            caps[id(op)] = n = capacity(op, n)

    dev = scan._relation.device

    def run_fused():
        batch = scan.batch()
        counters = {}   # (op, attribute) -> device scalar
        totals = {}     # op -> device scalar of its expansion's true total
        for op in ops:
            if isinstance(op, AlgTop):
                counters[op, "_count"] = (
                    batch.mask.to(I64).sum() if batch.mask is not None
                    else torch.tensor(batch.n, dtype=I64, device=dev))
            elif isinstance(op, AlgSelection):  # covers AlgDynSelection
                batch = op.select(batch)
                counters[op, "_count"] = batch.mask.to(I64).sum()
            elif isinstance(op, AlgHashJoinProbe):
                table = op._build.hashtable()
                res = op.probe(batch, table)
                batch, total = op.join(batch, table, res, caps[id(op)],
                                       True)
                counters[op, "_count"] = (
                    res.num_matches if op._residual is None
                    else batch.mask.to(I64).sum())
                counters[op, "num_cmps"] = res.num_cmps
                totals[op] = total
            elif isinstance(op, AlgNestJoinProbe):
                batch, res = op.join(batch, op._build.hashtable())
                counters[op, "_count"] = res.num_matches
                counters[op, "num_cmps"] = res.num_cmps
            elif isinstance(op, AlgUnnestHt):
                batch, total = op.expand(batch, op.group_lens(batch),
                                         caps[id(op)])
                counters[op, "_count"] = (
                    total if op._residual is None
                    else batch.mask.to(I64).sum())
                totals[op] = total
            else:
                raise NotImplementedError(
                    f"compile_strand: unsupported operator {op.name}")
        return batch, counters, totals

    def run():
        """Run the strand; fills every operator's counters and the
        AlgTop's result, and returns the AlgTop."""
        scan.reset()
        for op in ops:
            op.reset()
        batch, counters, totals = run_fused()
        keys = [*counters, *totals]
        scalars = [*counters.values(), *totals.values()]
        # every counter in one transfer
        values = dict(zip(keys, torch.stack(
            [s.to(I64).reshape(()) for s in scalars]).tolist()))
        scan._count = scan._relation.card
        for (op, attr) in counters:
            setattr(op, attr, values[op, attr])
        for op in totals:
            op.expanded = values[op]
            if values[op] > caps[id(op)]:
                raise ValueError(
                    f"{op.name}: fused capacity {caps[id(op)]} exceeded "
                    f"(true total {values[op]}); re-run interpreted or "
                    "pass a larger out_sizes hint")
        top = ops[-1]
        mask = (batch.mask if batch.mask is not None else
                torch.ones(batch.n, dtype=torch.bool, device=dev))
        top.result = Batch(dict(batch.columns), mask, dict(batch.nests),
                           dict(batch.dtypes))
        for op in ops:
            op.stop_timer()
        scan.stop_timer()
        return top

    return run
