"""Experiment 4 (two key/foreign-key joins R |><| S |><| T): the device plans.

Port of ``hashjoin3d_tpu/models/exp4.py`` (``main_experiment4.cc``): an
"inverted star" -- a key relation R (R.k the iota 0 .. 2^R - 1) and two FK
relations S and T whose FK columns share the 2^R >> alpha common keys
(``A`` times each) and each reference 2^R >> beta keys of their own (``B``
times each).  Rows of R |><| S whose key has no T partner die at the
second probe while still nested, so the unnest work follows the final
result, not the intermediate one.  Plans (``main_experiment4.cc:158-164``):

  Ndu   3D tables, both unnests deferred after both probes
  Chj   chaining tables, the RS pairs expanded before the T probe
  Nnu   3D tables, no unnest: nested tuples straight to the top (the
        reference declares it but implements no run; this follows the JAX
        harness, as exp-1's NrsNU)

Both tables are the compacted builds with the key-domain index over
[0, nCommon + 2 nExcl) (the chaining ones without the early-exit index);
the probes are the windowed strands of ``ops/strands_windowed.py``.
``_ndu_probe_strand``, ``_nnu_probe_strand`` and ``_chj_probe_strand`` are
the clarity strands of the same plans (``probe_nested`` /
``probe_chaining``, ``expand``-based unnest and materialisation): not on
the run path, they are the baselines the windowed strands are held
against, as in the JAX package.  Each
plan times its S build, its T build and its probe strand with the
reference's repetition protocol (>= 300 ms, >= 8 reps, synchronised) and
writes one CSV row with the reference's header; the c_* columns are
bit-equal to the reference binaries'.

Every run names its device; asking for CUDA on a host without it raises.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops.chaining import (build_chaining_host, materialize_chaining_join,
                            probe_chaining)
from ..ops.layout import I32, I64, from_numpy_u32, resolve_device
from ..ops.nested import (build_nested_host, deferred_two_join_strand,
                          probe_nested)
from ..ops.strands_windowed import (chj_strand_sorted, ndu_strand_sorted,
                                    nnu_strand_sorted)
from ..utils.csv_writer import CSVWriter
from ..utils.gen import exp4_data
from ..utils.measure import Timers, repeat_mintime, sync
from .exp1 import check_route

PLAN_NAMES = ["Ndu", "Chj", "Nnu"]
#: what ``all`` selects: the reference's runnable plans
DEFAULT_PLANS = ["Ndu", "Chj"]
#: plans_e bit values (main_experiment4.cc:158-164)
PLAN_BITS = {"Ndu": 1, "Nnu": 2, "Chj": 4}

CSV_HEADER = [
    "mintime", "minreps", "log2CardR", "a", "aM", "b", "bM",
    "cardR", "cardS", "cardT",
    "plan", "ht_impl", "reps",
    "t_total", "t_build_S", "t_build_T", "t_probe_R",
    "c_sc_R", "c_sc_S", "c_sc_T", "c_build_S", "c_build_T",
    "c_probe_RS", "c_probe_RS_cmp", "c_probe_RT", "c_probe_RT_cmp",
    "c_unnest_S", "c_unnest_T", "c_top",
]


def _ndu_probe_strand(tbl_s, tbl_t, r_k, out1: int, out2: int) -> dict:
    """scan R -> NestProbe(S) -> NestProbe(T) -> Unnest(T) -> Unnest(S) ->
    Top (``ops.nested.deferred_two_join_strand``); ``c_top`` is the second
    unnest's count."""
    out = deferred_two_join_strand(tbl_s, tbl_t, r_k, out1, out2)
    out.pop("valid")
    out["c_top"] = out["c_unnest_2"]
    return out


def _nnu_probe_strand(tbl_s, tbl_t, r_k) -> dict:
    """scan R -> NestProbe(S) -> NestProbe(T) -> Top, no unnest: each
    surviving R row carries its two group ids (-1 elsewhere); ``c_top``
    counts the nested tuples, as exp-1's NrsNU."""
    rs = probe_nested(tbl_s, r_k)
    rst = probe_nested(tbl_t, r_k, mask=rs.hit)
    both = rst.hit
    return dict(g_s=torch.where(both, rs.g, -1),
                g_t=torch.where(both, rst.g, -1),
                c_probe_RS=rs.num_matches, c_probe_RS_cmp=rs.num_cmps,
                c_probe_RT=rst.num_matches, c_probe_RT_cmp=rst.num_cmps,
                c_top=rst.num_matches.to(I64))


def _chj_probe_strand(tbl_s, tbl_t, r_k, out1: int, out2: int) -> dict:
    """scan R -> Probe(S) -> Probe(T) -> Top with the RS pairs expanded
    before the T probe (``main_experiment4.cc:943-1043``), which runs once
    a pair on the pair's R key (HashfunRS, ``main_experiment4.cc:355-361``).
    """
    prs = probe_chaining(tbl_s, r_k)
    r_row1, s_row1, v1, _ = materialize_chaining_join(tbl_s, prs, out1)
    pair_keys = r_k[torch.clamp(r_row1, min=0).long()]
    prt = probe_chaining(tbl_t, pair_keys, mask=v1)
    pr_row2, t_row2, v2, n_rst = materialize_chaining_join(tbl_t, prt, out2)
    pr2 = torch.clamp(pr_row2, min=0).long()
    return dict(r_row=torch.where(v2, r_row1[pr2], -1),
                s_row=torch.where(v2, s_row1[pr2], -1), t_row=t_row2,
                c_probe_RS=prs.num_matches, c_probe_RS_cmp=prs.num_cmps,
                c_probe_RT=prt.num_matches, c_probe_RT_cmp=prt.num_cmps,
                c_top=n_rst)


def resolve_plans(plans) -> set:
    """Plan names (``nnu`` in any case), ``all``/``none`` and numeric
    ``plans_e`` bitmask values to a set of names; unknown names raise."""
    out = set()
    for p in plans:
        for item in str(p).split(","):
            if not item:
                continue
            if item.lower() == "all":
                out.update(DEFAULT_PLANS)
            elif item.lower() == "none":
                pass
            elif item.lower() == "nnu":
                out.add("Nnu")
            elif item in PLAN_NAMES:
                out.add(item)
            elif item.isdigit():
                mask = int(item)
                out.update(n for n, b in PLAN_BITS.items() if mask & b)
            else:
                raise ValueError(f"unknown plan {item!r}")
    return out


class Cardinalities(NamedTuple):
    """The derived cardinalities of one parameter combination
    (``main_experiment4.cc:208-227,584-597``)."""

    card_r: int
    num_fk_common: int
    num_fk_exclusive: int
    card_fk_common: int
    card_fk_exclusive: int

    @classmethod
    def of(cls, log2_card_r, alpha, mult_alpha, beta, mult_beta):
        card_r = 1 << log2_card_r
        common, excl = card_r >> alpha, card_r >> beta
        return cls(card_r, common, excl, common * mult_alpha,
                   excl * mult_beta)

    @property
    def card_fk_relations(self) -> int:
        """|S| = |T|."""
        return self.card_fk_common + self.card_fk_exclusive

    @property
    def join_card1(self) -> int:
        """|R |><| S| = |R |><| T| = |S|."""
        return self.card_fk_relations

    def join_card2(self, mult_alpha: int) -> int:
        """|R |><| S |><| T| = numFkCommon * A^2."""
        return self.num_fk_common * mult_alpha ** 2


class Experiment4:
    """One parameter combination of experiment 4, on ``device``."""

    def __init__(self, log2_card_r: int, alpha: int, mult_alpha: int,
                 beta: int, mult_beta: int, measure_file=None,
                 plans=("all",), min_runtime_s: float = 0.3,
                 min_repeat: int = 8, trace: bool = True,
                 assert_route: int | None = 0, *, device):
        self.log2_card_r = log2_card_r
        self.alpha, self.beta = alpha, beta
        self.mult_alpha, self.mult_beta = mult_alpha, mult_beta
        self.plans = resolve_plans(plans)
        self.device = resolve_device(device)
        self.min_runtime_s = min_runtime_s
        self.min_repeat = min_repeat
        self.trace = trace
        self.assert_route = assert_route
        self.csv = CSVWriter(measure_file)
        self.timers = Timers()
        self.card = Cardinalities.of(log2_card_r, alpha, mult_alpha, beta,
                                     mult_beta)
        self.rk = self.sa = self.ta = None
        #: plan -> (S table, T table, probe strand output) of the last run
        self.results = {}

    @property
    def card_r(self) -> int:
        return self.card.card_r

    @property
    def num_fk_common(self) -> int:
        return self.card.num_fk_common

    @property
    def num_fk_exclusive(self) -> int:
        return self.card.num_fk_exclusive

    @property
    def card_s(self) -> int:
        return self.card.card_fk_relations

    card_t = card_s

    def calc_join_card1(self) -> int:
        return self.card.join_card1

    def calc_join_card2(self) -> int:
        return self.card.join_card2(self.mult_alpha)

    @property
    def key_domain(self) -> int:
        """FK values lie in [0, nCommon + 2 nExcl): S.a below nCommon +
        nExcl, T.a's exclusive values above it."""
        return self.num_fk_common + 2 * self.num_fk_exclusive

    def init(self, shuffle: bool = True) -> None:
        """Generate the inputs (bit-exact vs the reference) on the device."""
        if self.card_r < self.key_domain:
            # the reference asserts this (main_experiment4.cc:519) with its
            # asserts compiled out, so its binaries run such configurations
            sys.stderr.write(
                "warning: cardR < numFkCommon + 2*numFkExclusive -- "
                "T-exclusive FK values exceed R's key domain and will "
                "never match (the reference runs this config the same "
                "way, its assert being compiled out)\n")
        self.timers.start("init")
        sa, ta = exp4_data(self.log2_card_r, self.alpha, self.mult_alpha,
                           self.beta, self.mult_beta, shuffle)
        self.rk = torch.arange(self.card_r, dtype=I32, device=self.device)
        self.sa = from_numpy_u32(sa, self.device)
        self.ta = from_numpy_u32(ta, self.device)
        sync(self.device)
        self.timers.stop("init")

    def print_relations(self, out=None) -> None:
        """The three relations as the reference prints them (``key|0``
        rows of R, ``row|fk`` rows of S and T)."""
        out = out or sys.stdout
        for name, rel in (("R", None), ("S", self.sa), ("T", self.ta)):
            out.write(f"-- {name} --\n")
            if rel is None:
                for k in range(self.card_r):
                    out.write(f"{k}|0\n")
            else:
                for i, a in enumerate(rel.cpu().numpy().view(np.uint32)):
                    out.write(f"{i}|{a}\n")

    def print_config(self, out=None) -> None:
        out = out or sys.stdout
        out.write(
            "Data Generation Config\n"
            f"  |R|: {self.card_r}  |S|: {self.card_s}  |T|: {self.card_t}\n"
            f"  FK_Common  dv={self.num_fk_common} mult={self.mult_alpha}"
            f" card={self.card.card_fk_common}\n"
            f"  FK_Excl    dv={self.num_fk_exclusive} mult={self.mult_beta}"
            f" card={self.card.card_fk_exclusive}\n"
            f"  card(j(R,Fk)):  {self.calc_join_card1()}\n"
            f"  card(j(R,S,T)): {self.calc_join_card2()}\n")

    @staticmethod
    def print_param_table(out=None, log2_range=(10, 26)) -> None:
        """Every parameter combination with its derived cardinalities
        (``main_experiment4.cc:659-726``)."""
        out = out or sys.stdout
        out.write("r  a  am b  bm cardR cardS cardT FkC_dv FkC_mul FkC_card "
                  "FkE_dv FkE_mul FkE_card c(RS) c(RST)\n")
        ctr = 0
        for lr in range(*log2_range):
            for a in range(lr + 1):
                for am in range(1, 10):
                    for b in range(lr + 1):
                        for bm in range(1, 10):
                            c = Cardinalities.of(lr, a, am, b, bm)
                            s = c.card_fk_relations
                            out.write(
                                f"{lr} {a} {am} {b} {bm} {c.card_r} {s} {s}"
                                f" {c.num_fk_common} {am} {c.card_fk_common}"
                                f" {c.num_fk_exclusive} {bm}"
                                f" {c.card_fk_exclusive} {c.join_card1}"
                                f" {c.join_card2(am)}\n")
                            ctr += 1
        out.write(f"Counter: {ctr}\n")

    def print_timers(self) -> None:
        self.timers.print()

    def write_header(self) -> None:
        self.csv.write_fields(*CSV_HEADER).newline()

    def _write_params(self) -> None:
        self.csv.write_fields(
            f"{int(self.min_runtime_s * 1e3)}ms", self.min_repeat,
            self.log2_card_r, self.alpha, self.mult_alpha, self.beta,
            self.mult_beta, self.card_r, self.card_s, self.card_t)

    def build(self, name: str, keys: torch.Tensor):
        """A plan's table over one FK column: the exact distinct-FK count
        is known, so the build reads nothing back; Chj's chaining tables
        skip the early-exit index (its probes never stop early)."""
        num_dv_fk = self.num_fk_common + self.num_fk_exclusive
        if name == "Chj":
            return build_chaining_host(keys, num_dv_fk, n_keys=num_dv_fk,
                                       key_domain=self.key_domain,
                                       early_exit_index=False)
        return build_nested_host(keys, num_dv_fk, n_keys=num_dv_fk,
                                 key_domain=self.key_domain)

    def probe(self, name: str, tbl_s, tbl_t, rk: torch.Tensor) -> dict:
        """A plan's probe strand over the iota R.k (``models/exp4.py:
        388-404`` of the JAX package)."""
        card2 = max(self.calc_join_card2(), 1)
        if name == "Nnu":
            return nnu_strand_sorted(tbl_s, tbl_t, rk)
        if name == "Ndu":
            out1 = max(self.calc_join_card2() // max(self.mult_alpha, 1), 1)
            out = ndu_strand_sorted(tbl_s, tbl_t, rk, out1, card2)
            out.pop("valid")
            out["c_top"] = out["c_unnest_2"]
            return out
        if name == "Chj":
            return chj_strand_sorted(tbl_s, tbl_t, rk,
                                     max(self.calc_join_card1(), 1), card2)
        raise ValueError(f"unknown plan {name!r}")

    def run_plan(self, name: str) -> dict:
        """Warm up, time the S build, the T build and the probe strand,
        write the plan's CSV row (``main_experiment4.cc:832-1043``)."""
        self.timers.start(f"run{name}")
        ws, wt = self.build(name, self.sa), self.build(name, self.ta)
        self.probe(name, ws, wt, self.rk)  # warm-up, untimed
        mem = dict(S=ws.memory_consumption(), T=wt.memory_consumption())
        del ws, wt
        t_bs, reps_bs, tbl_s = repeat_mintime(
            self.min_runtime_s, lambda: self.build(name, self.sa),
            self.device, self.min_repeat)
        t_bt, reps_bt, tbl_t = repeat_mintime(
            self.min_runtime_s, lambda: self.build(name, self.ta),
            self.device, self.min_repeat)
        t_p, reps, out = repeat_mintime(
            self.min_runtime_s, lambda: self.probe(name, tbl_s, tbl_t,
                                                   self.rk),
            self.device, self.min_repeat)
        per = dict(bs=t_bs / reps_bs, bt=t_bt / reps_bt, probe=t_p / reps)
        if self.trace:
            print(f"Plan {name} [{self.device}]: reps {reps}, probe "
                  f"{per['probe'] * 1e3:.3f} ms, c_top {int(out['c_top'])}")
            for rel, m in mem.items():
                print(f"  {rel}: ht memory: " + ", ".join(
                    f"{k} {v:,}" for k, v in m.items()) + " bytes")
            print(f"  route_worst {out['route_worst']}, "
                  f"route_nbad {out['route_nbad']}")
        check_route(name, out, self.assert_route)
        self.results[name] = (tbl_s, tbl_t, out)

        self._write_params()
        self.csv.write_fields(
            name, "chaining" if name == "Chj" else "nested", reps,
            int(sum(per.values()) * 1e9),
            int(per["bs"] * 1e9), int(per["bt"] * 1e9),
            int(per["probe"] * 1e9),
            self.card_r, self.card_s, self.card_t,
            self.card_s, self.card_t,
            int(out["c_probe_RS"]), int(out["c_probe_RS_cmp"]),
            int(out["c_probe_RT"]), int(out["c_probe_RT_cmp"]),
            int(out["c_unnest_1"]) if "c_unnest_1" in out else "NA",
            int(out["c_unnest_2"]) if "c_unnest_2" in out else "NA",
            int(out["c_top"]),
        ).newline()
        self.timers.stop(f"run{name}")
        return out

    def run(self) -> None:
        """Write the CSV header and one row per plan in the reference's
        dispatch order (Ndu, Chj, Nnu); closes a CSV file the experiment
        opened."""
        try:
            self.timers.start("run")
            self.write_header()
            for name in PLAN_NAMES:
                if name in self.plans:
                    self.run_plan(name)
            self.timers.stop("run")
        finally:
            self.csv.close()
