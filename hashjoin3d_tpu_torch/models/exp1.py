"""Experiment 1 (key/foreign-key hash join R |><| S), plan Csr.

Port of ``hashjoin3d_tpu/models/exp1.py`` for plan Csr (chaining table,
build R, probe S, early exit; ``main_experiment1.cc:623-744``): R.k is a
shuffled iota of 2^R keys, S.a 2^S foreign keys over [0, 2^(R-t)).  The
build is the dense-direct chaining build, the probe the sorted windowed
strand.  Each is timed with the reference's repetition protocol (>= 300 ms,
>= 8 reps) and the plan writes one CSV row with the reference's header;
the c_* and ht_* columns are bit-equal to the reference binaries'.

Every run names its device; asking for CUDA on a host without it raises.
"""

from __future__ import annotations

from ..ops.chaining import build_chaining_host, can_use_dense_direct
from ..ops.layout import from_numpy_u32, resolve_device
from ..ops.stats import chaining_statistics
from ..ops.strands_windowed import direct_probe_strand_sorted
from ..utils.csv_writer import CSVWriter
from ..utils.gen import exp1_data
from ..utils.measure import repeat_mintime

PORTED_PLANS = ("Csr",)
#: plans of the JAX harness still to port -> ROADMAP slice
PENDING_PLANS = {"scr": 2, "scs": 2, "CsrUU": 2, "Nsr": 2, "Crs": 3,
                 "Nrs": 3, "NrsNU": 3, "CsrSel": 3, "CrsSel": 3, "NrsSel": 3}

CSV_HEADER = [
    "mintime", "minreps", "log2CardR", "log2CardS", "skew", "t", "fkMax",
    "numDvSa", "b",
    "plan", "ht_impl", "build", "probe", "ht_buckets", "ht_fracEmpty",
    "cc0_avg", "cc0_min", "cc0_max", "cc1_avg", "cc1_min", "cc1_max",
    "reps", "t_total", "t_buildStr", "t_probeStr", "t_top",
    "c_scanBuild", "c_selBuild", "c_htBuild", "c_scanProbe", "c_selProbe",
    "c_htProbe", "c_htProbeCmp", "c_unnest", "c_top",
]


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


class Experiment1:
    """One parameter combination of experiment 1, on ``device``."""

    def __init__(self, log2_card_r: int, log2_card_s: int, skew: bool, t: int,
                 b: int = 1, measure_file=None, plans=("Csr",),
                 min_runtime_s: float = 0.3, min_repeat: int = 8,
                 trace: bool = True, assert_route: int | None = 0, *,
                 device):
        if not 0 <= t <= log2_card_r:
            raise ValueError("need 0 <= t <= log2_card_r")
        for p in plans:
            if p in PENDING_PLANS:
                raise NotImplementedError(
                    f"plan {p} is not ported yet (ROADMAP slice "
                    f"{PENDING_PLANS[p]})")
            if p not in PORTED_PLANS:
                raise ValueError(f"unknown plan {p!r}")
        self.device = resolve_device(device)
        self.log2_card_r = log2_card_r
        self.log2_card_s = log2_card_s
        self.skew = skew
        self.t = t
        self.b = b
        self.plans = set(plans)
        self.min_runtime_s = min_runtime_s
        self.min_repeat = min_repeat
        self.trace = trace
        self.assert_route = assert_route
        self.csv = CSVWriter(measure_file)
        self.num_dv_sa = None
        self.rk = self.sa = None
        self.dense_direct_r = False
        #: plan -> (table, probe strand output) of the last timed run
        self.results = {}

    @property
    def card_r(self) -> int:
        return 1 << self.log2_card_r

    @property
    def fk_max(self) -> int:
        return 1 << (self.log2_card_r - self.t)

    def init(self) -> None:
        """Generate the inputs (bit-exact vs the reference) on the device."""
        rk, sa, ndv = exp1_data(self.log2_card_r, self.log2_card_s, self.skew,
                                self.t)
        self.num_dv_sa = ndv
        # R.k is a permutation by construction (main_experiment1.cc:425-428)
        self.dense_direct_r = can_use_dense_direct(
            rk, max(self.card_r // self.b, 1))
        self.rk = from_numpy_u32(rk, self.device)
        self.sa = from_numpy_u32(sa, self.device)

    def _write_params(self) -> None:
        self.csv.write_fields(
            f"{int(self.min_runtime_s * 1e3)}ms", self.min_repeat,
            self.log2_card_r, self.log2_card_s, self.skew, self.t,
            self.fk_max, self.num_dv_sa, self.b)

    def _run_join_plan(self, name, build_keys, probe_keys, build_fn,
                       probe_fn, impl, build_rel, probe_rel):
        """Warm up, time the build strand and the probe strand, write the
        plan's CSV row (``main_experiment1.cc:623-744``)."""
        probe_fn(build_fn(build_keys), probe_keys)  # warm-up, untimed
        t_build, reps_b, table = repeat_mintime(
            self.min_runtime_s, lambda: build_fn(build_keys), self.device,
            self.min_repeat)
        t_probe, reps, out = repeat_mintime(
            self.min_runtime_s, lambda: probe_fn(table, probe_keys),
            self.device, self.min_repeat)
        durs = dict(build=t_build / reps_b * reps, probe=t_probe,
                    total=(t_build / reps_b + t_probe / reps) * reps,
                    last_probe=t_probe / reps)
        if self.trace:
            print(f"Plan {name} [{self.device}]")
            print(f"  reps {reps}, build {durs['build'] / reps * 1e3:.3f} ms, "
                  f"probe {durs['probe'] / reps * 1e3:.3f} ms")
            print(f"  route_worst {out['route_worst']}, "
                  f"route_nbad {out['route_nbad']}")
        check_route(name, out, self.assert_route)
        self.results[name] = (table, out)

        row = [
            name, impl, build_rel, probe_rel,
            *chaining_statistics(table),
            reps,
            int(durs["total"] / reps * 1e9),
            int(durs["build"] / reps * 1e9),
            int(durs["probe"] / reps * 1e9),
            int(durs["last_probe"] * 1e9),
            len(build_keys), "NA", len(build_keys),
            len(probe_keys), "NA",
            int(out["c_htProbe"]), int(out["c_htProbeCmp"]),
            "NA",
            int(out["total"]),
        ]
        self._write_params()
        self.csv.write_fields(*row).newline()
        return out

    def run(self) -> None:
        """Write the CSV header and one row per plan; closes a CSV file the
        experiment opened."""
        try:
            self.csv.write_fields(*CSV_HEADER).newline()
            if "Csr" in self.plans:
                self._run_csr()
        finally:
            self.csv.close()

    def _run_csr(self) -> None:
        if not self.dense_direct_r:
            raise NotImplementedError(
                "Csr without the dense-direct layout needs the compacted "
                "build (ROADMAP slice 3)")
        nb_r = max(self.card_r // self.b, 1)
        self._run_join_plan(
            "Csr", self.rk, self.sa,
            lambda keys: build_chaining_host(
                keys, nb_r, dense_direct=True, n_keys=self.card_r),
            lambda tbl, p: direct_probe_strand_sorted(tbl, p, unique=True),
            "chaining", "R", "S")
