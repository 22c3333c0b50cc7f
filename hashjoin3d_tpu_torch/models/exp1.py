"""Experiment 1 (key/foreign-key hash join R |><| S): the device plans.

Port of ``hashjoin3d_tpu/models/exp1.py`` (``main_experiment1.cc``): R.k is
a shuffled iota of 2^R keys, S.a 2^S foreign keys over [0, 2^(R-t)),
uniform or zipf(1.0).  All eleven plans of the JAX harness:

  scr/scs  scan-only calibration (one un-repeated scan -> top run)
  Csr      chaining table, build R probe S, early exit
  CsrUU    the same without early exit (whole chains counted)
  Crs      chaining table, build S probe R (duplicate chains)
  Nsr      3D table, build R probe S, + unnest
  Nrs      3D table, build S probe R, + unnest
  NrsNU    3D table, build S probe R, nested tuples straight to the top
  CsrSel, CrsSel, NrsSel
           Csr, Crs and Nrs with a selection pushed under the probe
           (``attr < domain / 2``); the reference declares them but never
           implements them, so their rows hold to the JAX harness's

The R-side builds are the dense-direct ones (R.k is a permutation), the
S-side builds the compacted ones with the key-domain index (Crs's and
CrsSel's without the early-exit index); the probes are the sorted
windowed strands.  Where R.k fails the dense-direct check
(``dense_direct_r`` False), Csr, CsrUU and Nsr build R compacted and probe
with the clarity strands (``probe_chaining`` / ``probe_nested``, then
``materialize_chaining_join`` / ``unnest``), as the JAX harness does;
CsrSel needs the dense-direct layout.  Each join plan times its build
strand and its probe strand with the reference's repetition protocol
(>= 300 ms, >= 8 reps) and writes one CSV row with the reference's header;
the c_* and ht_* columns are bit-equal to the reference binaries'.  The
scan plans' rows omit ``reps``, the reference's quirk.

``backend`` (default ``"device"``) picks where the join plans run:
``"host"`` runs them on the native C++ engine (``hostengine.py``; the same
counters and ``ht_*`` columns, from ``*_statistics_np``), ``"auto"`` sends
a plan whose build + probe + output rows fall under
:attr:`Experiment1.HOST_CROSSOVER_ROWS` there.  The *Sel plans stay on the
device (the engine has no filtered probe), as in the JAX harness.

Every run names its device; asking for CUDA on a host without it raises.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, NamedTuple

import torch

from ..ops.chaining import (build_chaining_host, can_use_dense_direct,
                            materialize_chaining_join, probe_chaining)
from ..ops.layout import SIGN, from_numpy_u32, resolve_device, u32_to_i64
from ..ops.nested import build_nested_host, probe_nested, unnest
from ..ops.stats import (chaining_statistics, chaining_statistics_np,
                         nested_statistics, nested_statistics_np)
from ..ops.strands_windowed import (_with_route, direct_probe_strand_sorted,
                                    keydirect_chaining_strand_sorted,
                                    keydirect_nested_strand_sorted)
from ..utils.csv_writer import CSVWriter
from ..utils.gen import exp1_data
from ..utils.measure import Timers, repeat_mintime, sync

PLAN_NAMES = ["scr", "scs", "Csr", "CsrUU", "Crs", "Nsr", "Nrs", "NrsNU",
              "CsrSel", "CrsSel", "NrsSel"]
#: what ``all`` selects: the reference's ALL mask (main_experiment1.cc:111)
DEFAULT_PLANS = ["scr", "scs", "Csr", "CsrUU", "Crs", "Nsr", "Nrs", "NrsNU"]
#: plans_e bit values (main_experiment1.cc:96-113); the Sel bits are the
#: reference's commented-out values
PLAN_BITS = {"scr": 1, "scs": 2, "Csr": 4, "Crs": 8, "Nrs": 16, "Nsr": 32,
             "NrsNU": 64, "CsrSel": 128, "CrsSel": 256, "NrsSel": 512,
             "CsrUU": 8192}

CSV_HEADER = [
    "mintime", "minreps", "log2CardR", "log2CardS", "skew", "t", "fkMax",
    "numDvSa", "b",
    "plan", "ht_impl", "build", "probe", "ht_buckets", "ht_fracEmpty",
    "cc0_avg", "cc0_min", "cc0_max", "cc1_avg", "cc1_min", "cc1_max",
    "reps", "t_total", "t_buildStr", "t_probeStr", "t_top",
    "c_scanBuild", "c_selBuild", "c_htBuild", "c_scanProbe", "c_selProbe",
    "c_htProbe", "c_htProbeCmp", "c_unnest", "c_top",
]


def resolve_plan_items(plans, names, bits, all_names=None) -> set:
    """Plan names, ``all``/``none`` and numeric ``plans_e`` bitmask values
    (``4,8`` and ``12`` both select Csr and Crs) to a set of names; unknown
    names raise.  ``all_names`` narrows what ``all`` selects."""
    out = set()
    for p in plans:
        for item in str(p).split(","):
            if not item:
                continue
            if item.lower() == "all":
                out.update(all_names or names)
            elif item.lower() == "none":
                pass
            elif item in names:
                out.add(item)
            elif item.isdigit():
                mask = int(item)
                out.update(n for n, b in bits.items() if mask & b)
            else:
                raise ValueError(f"unknown plan {item!r}")
    return out


class RouteDegradation(RuntimeError):
    """A strand's windowed lookup left the pure windowed route
    (``route_worst`` above the allowance)."""


def check_route(plan_name: str, out: dict, allowance: int | None) -> None:
    """Raise when ``out['route_worst']`` exceeds ``allowance`` (None
    disables)."""
    if allowance is None:
        return
    route = int(out["route_worst"])
    if route > allowance:
        raise RouteDegradation(
            f"plan {plan_name}: route_worst={route} exceeds the allowed "
            f"{allowance} (route_nbad={int(out['route_nbad'])})")


def with_sel_count(out: dict, sel: torch.Tensor) -> dict:
    """A *Sel plan's strand output with ``c_selProbe``, the selection's
    output cardinality."""
    return dict(out, c_selProbe=sel.to(torch.int64).sum())


def sel_mask(keys: torch.Tensor, bound: int) -> torch.Tensor:
    """The *Sel predicate ``key < bound`` on the unsigned keys (a u32 key
    >= 2^31 is negative on the int32 carrier, and must not pass)."""
    return u32_to_i64(keys) < bound


class JoinPlan(NamedTuple):
    """A join plan's wiring: its build and probe columns, its strands and
    the CSV row's table columns."""

    build_keys: torch.Tensor
    probe_keys: torch.Tensor
    build: Callable   #: build keys -> table
    probe: Callable   #: (table, probe keys) -> strand output dict
    impl: str         #: ht_impl: "chaining" or "nested"
    build_rel: str
    probe_rel: str
    has_unnest: bool


@_with_route
def _chaining_probe_strand(table, probe_keys, out_size: int,
                           unique: bool) -> dict:
    """The clarity chaining strand: ``probe_chaining``, then
    ``materialize_chaining_join`` into ``out_size`` slots."""
    pr = probe_chaining(table, probe_keys, unique=unique)
    prow, brow, _, total = materialize_chaining_join(table, pr, out_size,
                                                     unique=unique)
    return dict(probe_row=prow, build_row=brow, total=total,
                c_htProbe=pr.num_matches, c_htProbeCmp=pr.num_cmps)


@_with_route
def _nested_probe_strand(table, probe_keys, out_size: int) -> dict:
    """The clarity 3D strand: ``probe_nested``, then ``unnest`` into
    ``out_size`` slots."""
    nb = probe_nested(table, probe_keys)
    prow, brow, _, total = unnest(table, nb, out_size)
    return dict(probe_row=prow, build_row=brow, total=total,
                c_htProbe=nb.num_matches, c_htProbeCmp=nb.num_cmps,
                c_unnest=total)


@_with_route
def _nested_probe_strand_nounnest(table, probe_keys) -> dict:
    """The clarity 3D strand with the nested tuples straight to the top:
    each probe row's group id under the hit mask."""
    nb = probe_nested(table, probe_keys)
    return dict(nested_g=nb.g, nested_hit=nb.hit,
                c_htProbe=nb.num_matches, c_htProbeCmp=nb.num_cmps,
                c_top=nb.num_matches)


def _scan_strand(col):
    """Scan -> Top: the column's u32 maximum and its count."""
    return (col ^ SIGN).max() ^ SIGN, col.shape[0]


#: the join plans' (build side, probe side, output) row volumes, for
#: ``backend="auto"`` (``models/exp1.py:485`` of the JAX package)
HOST_VOLUME = {"Csr": ("R", "S", "S"), "CsrUU": ("R", "S", "S"),
               "Nsr": ("R", "S", "S"), "Crs": ("S", "R", "S"),
               "Nrs": ("S", "R", "S"), "NrsNU": ("S", "R", None)}


class Experiment1:
    """One parameter combination of experiment 1, on ``device``."""

    #: ``backend="auto"``'s crossover: a join plan whose build + probe +
    #: output rows fall below it runs on the host engine.
    #: ``chip_smoke.py`` phase 10d on an NVIDIA H100 80GB HBM3 at 700 W
    #: (Csr and Nrs, ``t_total``): the engine's slower plan took 1.32 ms
    #: against the device's 3.39 ms at R12/S16 (135,168 rows), and 8.33
    #: against 3.07 ms at R14/S18 (540,672), the smallest size from which
    #: the device won at every larger one, in each of three runs.
    HOST_CROSSOVER_ROWS = 540_672

    def __init__(self, log2_card_r: int, log2_card_s: int, skew: bool, t: int,
                 b: int = 1, measure_file=None, plans=("all",),
                 min_runtime_s: float = 0.3, min_repeat: int = 8,
                 trace: bool = True, assert_route: int | None = 0, *,
                 device, backend: str = "device"):
        if backend not in ("device", "host", "auto"):
            raise ValueError(f"backend must be 'device', 'host' or 'auto', "
                             f"got {backend!r}")
        if not 0 <= t <= log2_card_r:
            raise ValueError("need 0 <= t <= log2_card_r")
        self.plans = resolve_plan_items(plans, PLAN_NAMES, PLAN_BITS,
                                        all_names=DEFAULT_PLANS)
        self.device = resolve_device(device)
        self.log2_card_r = log2_card_r
        self.log2_card_s = log2_card_s
        self.skew = skew
        self.t = t
        self.b = b
        self.min_runtime_s = min_runtime_s
        self.min_repeat = min_repeat
        self.trace = trace
        self.assert_route = assert_route
        self.backend = backend
        self.csv = CSVWriter(measure_file)
        self.timers = Timers()
        self.num_dv_sa = None
        self.rk = self.sa = None
        #: the host columns (u32 numpy) the host engine's plans read
        self.rk_np = self.sa_np = None
        self.dense_direct_r = False
        #: plan -> (table, probe strand output) of the last timed run
        self.results = {}

    @property
    def card_r(self) -> int:
        return 1 << self.log2_card_r

    @property
    def card_s(self) -> int:
        return 1 << self.log2_card_s

    @property
    def fk_max(self) -> int:
        return 1 << (self.log2_card_r - self.t)

    def init(self) -> None:
        """Generate the inputs (bit-exact vs the reference) on the device."""
        self.timers.start("init")
        rk, sa, ndv = exp1_data(self.log2_card_r, self.log2_card_s, self.skew,
                                self.t)
        self.num_dv_sa = ndv
        # R.k is a permutation by construction (main_experiment1.cc:425-428)
        self.dense_direct_r = can_use_dense_direct(
            rk, max(self.card_r // self.b, 1))
        self.rk_np, self.sa_np = rk, sa
        self.rk = from_numpy_u32(rk, self.device)
        self.sa = from_numpy_u32(sa, self.device)
        sync(self.device)
        self.timers.stop("init")

    def print_relations(self, out=None) -> None:
        """Both relations as the reference prints them (``key|0|0`` rows of
        R, ``row|fk|0`` rows of S)."""
        out = out or sys.stdout
        rk = self.rk.cpu().numpy().view("uint32")
        sa = self.sa.cpu().numpy().view("uint32")
        out.write("-- R --\n")
        for k in rk:
            out.write(f"{k}|0|0\n")
        out.write("-- S --\n")
        for i, a in enumerate(sa):
            out.write(f"{i}|{a}|0\n")

    def print_timers(self) -> None:
        self.timers.print()

    def _write_params(self) -> None:
        self.csv.write_fields(
            f"{int(self.min_runtime_s * 1e3)}ms", self.min_repeat,
            self.log2_card_r, self.log2_card_s, self.skew, self.t,
            self.fk_max, self.num_dv_sa, self.b)

    def _run_join_plan(self, name: str, plan: JoinPlan):
        """Warm up, time the build strand and the probe strand, write the
        plan's CSV row (``main_experiment1.cc:623-744``)."""
        self.timers.start(f"run{name}")
        build_keys, probe_keys = plan.build_keys, plan.probe_keys
        plan.probe(plan.build(build_keys), probe_keys)  # warm-up, untimed
        t_build, reps_b, table = repeat_mintime(
            self.min_runtime_s, lambda: plan.build(build_keys), self.device,
            self.min_repeat)
        t_probe, reps, out = repeat_mintime(
            self.min_runtime_s, lambda: plan.probe(table, probe_keys),
            self.device, self.min_repeat)
        durs = dict(build=t_build / reps_b * reps, probe=t_probe,
                    total=(t_build / reps_b + t_probe / reps) * reps,
                    last_probe=t_probe / reps)
        stats = (nested_statistics if plan.impl == "nested"
                 else chaining_statistics)(table)
        if self.trace:
            print(f"Plan {name} [{self.device}]")
            print(f"  reps {reps}, build {durs['build'] / reps * 1e3:.3f} ms, "
                  f"probe {durs['probe'] / reps * 1e3:.3f} ms")
            mem = table.memory_consumption()
            print("  ht memory: " + ", ".join(
                f"{k} {v:,}" for k, v in mem.items()) + " bytes")
            print(f"  route_worst {out['route_worst']}, "
                  f"route_nbad {out['route_nbad']}")
        check_route(name, out, self.assert_route)
        self.results[name] = (table, out)

        row = [
            name, plan.impl, plan.build_rel, plan.probe_rel,
            *stats.to_csv_fields(),
            reps,
            int(durs["total"] / reps * 1e9),
            int(durs["build"] / reps * 1e9),
            int(durs["probe"] / reps * 1e9),
            int(durs["last_probe"] * 1e9),
            len(build_keys), "NA", len(build_keys),
            len(probe_keys),
            int(out["c_selProbe"]) if "c_selProbe" in out else "NA",
            int(out["c_htProbe"]), int(out["c_htProbeCmp"]),
            int(out["c_unnest"]) if plan.has_unnest else "NA",
            int(out["c_top"] if "c_top" in out else out["total"]),
        ]
        self._write_params()
        self.csv.write_fields(*row).newline()
        self.timers.stop(f"run{name}")
        return out

    def _run_scan_plan(self, name, col) -> None:
        """scr / scs: one un-repeated scan -> top run
        (``main_experiment1.cc:532-621``), timed between two device
        synchronisations; the row omits ``reps`` like the reference's."""
        self.timers.start(f"run{name}")
        _scan_strand(col)  # warm-up, untimed
        sync(self.device)
        t0 = time.perf_counter()
        _, cnt = _scan_strand(col)
        sync(self.device)
        dt = time.perf_counter() - t0
        self._write_params()
        self.csv.write_fields(
            name, "NA", "NA", "NA", "NA", "NA", "NA", "NA", "NA", "NA",
            "NA", "NA",
            int(dt * 1e9),        # t_total
            "NA", "NA",
            int(dt * 1e9),        # t_top
            int(cnt),             # scan count
            "NA", "NA", "NA", "NA", "NA", "NA", "NA",
            int(cnt),             # c_top
        ).newline()
        self.timers.stop(f"run{name}")

    def write_header(self) -> None:
        self.csv.write_fields(*CSV_HEADER).newline()

    def run(self) -> None:
        """Write the CSV header and one row per plan, in the reference's
        order; closes a CSV file the experiment opened."""
        try:
            self.timers.start("run")
            self.write_header()
            for name in PLAN_NAMES:
                if name in self.plans:
                    self.run_plan(name)
            self.timers.stop("run")
        finally:
            self.csv.close()

    def run_plan(self, name: str) -> None:
        """Run one plan and write its CSV row (no header)."""
        if name == "scr":
            self._run_scan_plan("scr", self.rk)
        elif name == "scs":
            self._run_scan_plan("scs", self.sa)
        elif self._backend_for_plan(name) == "host":
            self._run_join_plan_host(name)
        else:
            self._run_join_plan(name, self.join_plan(name))

    def _backend_for_plan(self, name: str) -> str:
        """Where a join plan runs: the *Sel plans on the device, the rest
        on ``backend``, ``"auto"`` by the plan's row volume."""
        if name not in HOST_VOLUME or self.backend == "device":
            return "device"
        if self.backend == "host":
            return "host"
        card = {"R": self.card_r, "S": self.card_s, None: 0}
        vol = sum(card[side] for side in HOST_VOLUME[name])
        return "host" if vol < self.HOST_CROSSOVER_ROWS else "device"

    def _run_join_plan_host(self, name: str):
        """One join plan on the native host engine, the reference's
        protocol around its build and probe, one CSV row of the device
        rows' shape (``models/exp1.py:267-339`` of the JAX package)."""
        from ..hostengine import HostTable

        self.timers.start(f"run{name}")
        build_rel = HOST_VOLUME[name][0]
        bk, pk = ((self.rk_np, self.sa_np) if build_rel == "R"
                  else (self.sa_np, self.rk_np))
        nb = (max(self.card_r // self.b, 1) if build_rel == "R"
              else max(self.num_dv_sa // self.b, 1))
        impl = "nested" if name.startswith("N") else "chaining"
        unnest = name != "NrsNU"
        out_cap = max(self.card_s, 1)
        durs = dict(build=0.0, probe=0.0, last_probe=0.0)

        def once():
            t0 = time.perf_counter()
            table = HostTable(bk, nb, kind=impl)
            t1 = time.perf_counter()
            if impl == "nested":
                out = table.probe(pk, unnest=unnest, out_cap=out_cap)
            else:
                out = table.probe(pk, unique=name == "Csr", out_cap=out_cap)
            t2 = time.perf_counter()
            table.close()
            durs["build"] += t1 - t0
            durs["probe"] += t2 - t1
            durs["last_probe"] = t2 - t1
            return out

        once()  # warm the allocator and the page cache, untimed
        durs.update(build=0.0, probe=0.0)
        _, reps, out = repeat_mintime(self.min_runtime_s, once,
                                      torch.device("cpu"), self.min_repeat)
        stats = (nested_statistics_np if impl == "nested"
                 else chaining_statistics_np)(bk, nb)
        if self.trace:
            print(f"Plan {name} [host]")
            print(f"  reps {reps}, build {durs['build'] / reps * 1e3:.3f} "
                  f"ms, probe {durs['probe'] / reps * 1e3:.3f} ms")
        if impl == "nested":
            matches, cmps, unnested = out[2:]
            c_top = unnested if unnest else matches
            c_unnest = unnested if unnest else "NA"
        else:
            matches, cmps = out[2:]
            c_top, c_unnest = matches, "NA"
        self.results[name] = (None, out)
        row = [
            name, impl, build_rel, HOST_VOLUME[name][1],
            *stats.to_csv_fields(),
            reps,
            int((durs["build"] + durs["probe"]) / reps * 1e9),
            int(durs["build"] / reps * 1e9),
            int(durs["probe"] / reps * 1e9),
            int(durs["last_probe"] * 1e9),
            len(bk), "NA", len(bk),
            len(pk), "NA",
            int(matches), int(cmps), c_unnest, int(c_top),
        ]
        self._write_params()
        self.csv.write_fields(*row).newline()
        self.timers.stop(f"run{name}")
        return out

    def join_plan(self, name: str) -> JoinPlan:
        """A join plan's inputs and strands on this experiment's device, as
        the JAX harness wires them (``models/exp1.py:515-632``)."""
        nb_r = max(self.card_r // self.b, 1)      # build on R.k: #dv = |R|
        nb_s = max(self.num_dv_sa // self.b, 1)   # build on S.a: #dv(S.a)
        if name == "CsrSel" and not self.dense_direct_r:
            raise AssertionError(
                "CsrSel needs the dense-direct layout (R.k dense)")
        perm = self.dense_direct_r
        if name in ("Csr", "CsrUU", "Nsr") and not perm:
            return self._clarity_plan(name, nb_r)

        def build_r(keys, **kw):
            return build_chaining_host(keys, nb_r, dense_direct=True,
                                       n_keys=self.card_r, **kw)

        # S.a lies in [0, fkMax) by construction
        # (main_experiment1.cc:190): the key-domain index applies; Crs's
        # table is probed only without early exit
        def build_s_chaining(keys):
            return build_chaining_host(keys, nb_s, n_keys=self.num_dv_sa,
                                       key_domain=self.fk_max,
                                       early_exit_index=False)

        def build_s_nested(keys):
            return build_nested_host(keys, nb_s, n_keys=self.num_dv_sa,
                                     key_domain=self.fk_max)

        if name in ("Csr", "CsrUU"):
            unique = name == "Csr"
            return JoinPlan(
                self.rk, self.sa,
                lambda keys: build_r(keys, full_chain_index=not unique),
                lambda tbl, p: direct_probe_strand_sorted(tbl, p,
                                                          unique=unique),
                "chaining", "R", "S", has_unnest=False)
        if name == "Crs":
            return JoinPlan(
                self.sa, self.rk, build_s_chaining,
                lambda tbl, p: keydirect_chaining_strand_sorted(
                    tbl, p, self.card_s, probes_permutation=perm),
                "chaining", "S", "R", has_unnest=False)
        if name == "Nsr":
            return JoinPlan(
                self.rk, self.sa,
                lambda keys: build_nested_host(
                    keys, nb_r, dense_direct=True, n_keys=self.card_r),
                lambda tbl, p: direct_probe_strand_sorted(tbl, p,
                                                          nested=True),
                "nested", "R", "S", has_unnest=True)
        if name in ("Nrs", "NrsNU"):
            unnest = name == "Nrs"
            return JoinPlan(
                self.sa, self.rk, build_s_nested,
                lambda tbl, p: keydirect_nested_strand_sorted(
                    tbl, p, self.card_s if unnest else 1, do_unnest=unnest,
                    probes_permutation=perm),
                "nested", "S", "R", has_unnest=unnest)
        # the *Sel plans: the probe side passes ``attr < domain / 2`` first
        # (models/exp1.py:591-632 of the JAX package)
        if name == "CsrSel":
            half = max(self.fk_max // 2, 1)

            def probe(tbl, p):
                sel = sel_mask(p, half)
                return with_sel_count(direct_probe_strand_sorted(
                    tbl, p, unique=True, mask=sel), sel)

            return JoinPlan(self.rk, self.sa, build_r, probe, "chaining",
                            "R", "S", has_unnest=False)
        half = max(self.card_r // 2, 1)
        if name == "CrsSel":
            def probe(tbl, p):
                sel = sel_mask(p, half)
                return with_sel_count(keydirect_chaining_strand_sorted(
                    tbl, p, self.card_s, mask=sel), sel)

            return JoinPlan(self.sa, self.rk, build_s_chaining, probe,
                            "chaining", "S", "R", has_unnest=False)
        if name == "NrsSel":
            def probe(tbl, p):
                sel = sel_mask(p, half)
                return with_sel_count(keydirect_nested_strand_sorted(
                    tbl, p, self.card_s, do_unnest=True, mask=sel), sel)

            return JoinPlan(self.sa, self.rk, build_s_nested, probe,
                            "nested", "S", "R", has_unnest=True)
        raise ValueError(f"{name} is not a join plan")

    def _clarity_plan(self, name: str, nb_r: int) -> JoinPlan:
        """Csr, CsrUU or Nsr where R.k fails the dense-direct check
        (``models/exp1.py:510-564`` of the JAX package): R's compacted
        build (its distinct count known, nothing read back) and the
        clarity strand into |S| slots."""
        if name == "Nsr":
            return JoinPlan(
                self.rk, self.sa,
                lambda keys: build_nested_host(keys, nb_r,
                                               n_keys=self.card_r),
                lambda tbl, p: _nested_probe_strand(tbl, p, self.card_s),
                "nested", "R", "S", has_unnest=True)
        unique = name == "Csr"
        return JoinPlan(
            self.rk, self.sa,
            lambda keys: build_chaining_host(keys, nb_r, n_keys=self.card_r),
            lambda tbl, p: _chaining_probe_strand(tbl, p, self.card_s,
                                                  unique),
            "chaining", "R", "S", has_unnest=False)
