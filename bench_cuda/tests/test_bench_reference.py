"""The plain references against brute-force hash tables written the
artifact's way (one Python list a bucket), the judging of result rows,
and the control, which has to come out not correct."""

import random

import pytest
import torch

from bench_cuda import control, spec
from bench_cuda.recipes import instance_seed
from bench_cuda.refcore import fmix32
from bench_cuda.references import three_way, two_way

from . import t4crs
from .conftest import (DIST_CELL, one_card_cells, small_copy,
                       write_small_bench)

CPU = torch.device("cpu")


def fmix(k: int) -> int:
    k &= 0xFFFFFFFF
    k ^= k >> 16
    k = (k * 0x85EBCA6B) & 0xFFFFFFFF
    k ^= k >> 13
    k = (k * 0xC2B2AE35) & 0xFFFFFFFF
    return k ^ (k >> 16)


def chain_of(k, nb, shards):
    b = fmix(k) % nb
    return (fmix(fmix(k)) % shards) * nb + b if shards > 1 else b


def brute_chaining(build, probe, nb, shards=1, early_exit=True):
    """``ht_chaining.hh``: the first row of a bucket is its directory
    node, later rows go in right behind it; an early-exit probe stops at
    its key, any other walks its whole chain and matches every node of
    its key."""
    chains = {}
    for row, k in enumerate(build):
        c = chains.setdefault(chain_of(k, nb, shards), [])
        c.insert(1, (k, row)) if c else c.append((k, row))
    m = cmps = 0
    for k in probe:
        chain = chains.get(chain_of(k, nb, shards), [])
        if not early_exit:
            m += sum(bk == k for bk, _ in chain)
            cmps += len(chain)
            continue
        for i, (bk, _) in enumerate(chain):
            if bk == k:
                m += 1
                cmps += i + 1
                break
        else:
            cmps += len(chain)
    return dict(matches=m, cmps=cmps, total=m)


def brute_nested(build, probe, nb, shards=1, live=None):
    """``ht_nested.hh``: one main node a distinct key, appended at its
    chain's tail; a probe walks the main chain."""
    chains, rows = {}, {}
    for row, k in enumerate(build):
        if k not in rows:
            chains.setdefault(chain_of(k, nb, shards), []).append(k)
        rows.setdefault(k, []).append(row)
    m = cmps = total = 0
    hits = []
    for i, k in enumerate(probe):
        if live is not None and not live[i]:
            hits.append(False)
            continue
        chain = chains.get(chain_of(k, nb, shards), [])
        if k in rows:
            m += 1
            cmps += chain.index(k) + 1
            total += len(rows[k])
        else:
            cmps += len(chain)
        hits.append(k in rows)
    return dict(matches=m, cmps=cmps, total=total), hits, rows


def _cols(**cols):
    return {k: torch.tensor(v, dtype=torch.int32) for k, v in cols.items()}


def test_fmix32_is_murmur3s_finalizer():
    ks = [0, 1, 7, 2 ** 31, 2 ** 32 - 1, 123456789]
    got = fmix32(torch.tensor(ks, dtype=torch.int64)).tolist()
    assert got == [fmix(k) for k in ks]


@pytest.mark.parametrize("seed", range(4))
def test_two_way_chaining_early_exit_equals_brute_force(seed):
    rng = random.Random(seed)
    build = rng.sample(range(300), 200)             # unique keys
    probe = [rng.randrange(400) for _ in range(900)]  # hits and misses
    traffic = {"table": dict(kind="chaining", build="R", probe="S",
                             early_exit=True, buckets="build_rows")}
    got = two_way.expect(_cols(R=build, S=probe), {"b": 4}, traffic)
    assert got == brute_chaining(build, probe, 50)


@pytest.mark.parametrize("seed", range(4))
def test_two_way_chaining_without_early_exit_equals_brute_force(seed):
    rng = random.Random(seed)
    build = [rng.randrange(120) for _ in range(1500)]  # duplicate keys
    probe = rng.sample(range(400), 400)                # hits and misses
    traffic = {"table": dict(kind="chaining", build="S", probe="R",
                             early_exit=False, buckets="build_distinct")}
    got = two_way.expect(_cols(S=build, R=probe), {"b": 2}, traffic)
    assert got == brute_chaining(build, probe, len(set(build)) // 2,
                                 early_exit=False)


@pytest.mark.parametrize("seed,shards", [(0, 1), (1, 1), (2, 4), (3, 4)])
def test_two_way_nested_equals_brute_force(seed, shards):
    rng = random.Random(seed)
    build = [rng.randrange(250) for _ in range(1500)]
    probe = rng.sample(range(300), 300)
    cfg = ({"buckets_per_shard": 16, "ranks": shards} if shards > 1
           else {"b": 2})
    traffic = {"table": dict(kind="nested", build="S", probe="R",
                             early_exit=False,
                             buckets="config" if shards > 1
                             else "build_distinct")}
    got = two_way.expect(_cols(S=build, R=probe), cfg, traffic)
    nb = 16 if shards > 1 else len(set(build)) // 2
    assert got == brute_nested(build, probe, nb, shards)[0]


@pytest.mark.parametrize("seed", range(3))
def test_three_way_equals_brute_force(seed):
    rng = random.Random(seed)
    r = list(range(400))
    s = [rng.randrange(300) for _ in range(700)]
    t = [rng.randrange(150, 500) for _ in range(600)]
    got = three_way.expect(_cols(R=r, S=s, T=t), {}, {})
    cs, hit_s, rows_s = brute_nested(s, r, len(set(s)))
    ct, both, rows_t = brute_nested(t, r, len(set(t)), live=hit_s)
    keys = [k for k, h in zip(r, both) if h]
    assert got == dict(
        rs=cs["matches"], rs_cmp=cs["cmps"], rt=ct["matches"],
        rt_cmp=ct["cmps"], unnest_t=sum(len(rows_t[k]) for k in keys),
        total=sum(len(rows_s[k]) * len(rows_t[k]) for k in keys))


def _pairs_case():
    cols = _cols(R=[3, 1, 2, 0], S=[1, 1, 2, 5, 3])
    traffic = {"table": dict(kind="nested", build="R", probe="S",
                             early_exit=False, buckets="build_rows")}
    expected = two_way.expect(cols, {}, traffic)
    probe_row = [0, 1, 2, 4, -1, -1]
    build_row = [1, 1, 2, 0, -1, -1]
    return cols, traffic, expected, probe_row, build_row


def _judge(cols, traffic, expected, pr, br, **counters):
    c = dict(expected, **counters)
    return two_way.judge(cols, dict(probe_row=torch.tensor(pr),
                                    build_row=torch.tensor(br),
                                    counters=c), expected, traffic)


def test_judge_reads_a_right_answer_as_zero():
    cols, traffic, expected, pr, br = _pairs_case()
    assert expected["total"] == 4
    assert set(_judge(cols, traffic, expected, pr, br).values()) == {0}


@pytest.mark.parametrize("fault,pr,br,number", [
    ("missing", [0, 1, 2, -1], [1, 1, 2, -1], "rows_gap"),
    ("twice", [0, 1, 2, 4, 4], [1, 1, 2, 0, 0], "rows_dup"),
    ("wrong", [0, 1, 2, 3], [1, 1, 2, 0], "rows_bad"),
    ("half", [0, 1, 2, 4, 3], [1, 1, 2, 0, -1], "rows_bad"),
    ("outside", [0, 1, 2, 4, 9], [1, 1, 2, 0, 0], "rows_bad"),
])
def test_judge_catches_each_fault(fault, pr, br, number):
    cols, traffic, expected, _, _ = _pairs_case()
    assert _judge(cols, traffic, expected, pr, br)[number] > 0


def test_judge_reads_the_counters():
    cols, traffic, expected, pr, br = _pairs_case()
    got = _judge(cols, traffic, expected, pr, br,
                 cmps=expected["cmps"] + 2)
    assert got["cmps_gap"] == 2 and got["total_gap"] == 0


def test_three_way_judge_reads_triples():
    cols = _cols(R=[0, 1, 2], S=[1, 1, 0], T=[1, 2, 0, 1])
    expected = three_way.expect(cols, {}, {})
    assert expected["total"] == 5  # key 1: 2 x 2, key 0: 1 x 1
    good = dict(r_row=[1, 1, 1, 1, 0], s_row=[0, 0, 1, 1, 2],
                t_row=[0, 3, 0, 3, 2])
    kept = {k: torch.tensor(v) for k, v in good.items()}
    assert set(three_way.judge(cols, dict(kept, counters=expected),
                               expected, {}).values()) == {0}
    kept["t_row"] = torch.tensor([0, 3, 0, 3, 1])  # T row 1 holds key 2
    assert three_way.judge(cols, dict(kept, counters=expected), expected,
                           {})["rows_bad"] == 1


#: the control needs keys past 2^16 to differ from the u32 join
CONTROL_SIZES = {"exp1": dict(log2_card_r=17, log2_card_s=19),
                 "exp4": dict(log2_card_r=18)}


@pytest.mark.parametrize("cell", one_card_cells() + [DIST_CELL["name"]])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 77, 20261018])
def test_control_comes_out_not_correct(tmp_path, cell, seed):
    c = spec.load_cell(cell, write_small_bench(tmp_path, small=False))
    c.config = dict(c.config, **CONTROL_SIZES[c.config["recipe"]])
    limits = spec.module("references", c.traffic["reference"]).LIMITS
    nums = control.control_numbers(c, seed, CPU)
    assert any(nums[k] > limits[k] for k in limits)


def test_the_control_at_a_size_below_2_16_would_pass():
    """Why the control's test size is what it is: below 2^16 keys u16
    truncation changes nothing."""
    c = spec.load_cell("exp1-t0.csr")
    c.config = small_copy(c.config)
    assert set(control.control_numbers(c, 3, CPU).values()) == {0}


def _artifact_row(csv_name: str, plan: str) -> dict:
    """A plan's counters in one of the artifact's measure files."""
    lines = (spec.ROOT / "artifacts" / "r5" / csv_name).read_text().split()
    head = lines[0].split(";")
    row = next(dict(zip(head, ln.split(";"))) for ln in lines[1:]
               if ln.split(";")[head.index("plan")] == plan)
    return dict(matches=int(row["c_htProbe"]),
                cmps=int(row["c_htProbeCmp"]), total=int(row["c_top"]))


@pytest.fixture(scope="module")
def artifact_columns():
    """exp-1's columns as the artifact draws them, by ``-t``, made once."""
    from hashjoin3d_tpu_torch.utils.gen import exp1_data

    made = {}

    def columns(t):
        if t not in made:
            rk, sa, _ = exp1_data(20, 24, False, t)
            made[t] = _cols(R=rk.view("int32"), S=sa.view("int32"))
        return made[t]

    return columns


@pytest.mark.parametrize("t,csv_name,plan", [(4, "e1_t4.csv", "Crs"),
                                             (0, "e1_t0c.csv", "Crs"),
                                             (0, "e1_t0c.csv", "Csr")])
def test_two_way_gives_the_artifacts_counters_on_its_columns(
        artifact_columns, t, csv_name, plan):
    """At -R 20 -S 24 on the artifact's own columns: Crs walks every chain
    whole, Csr stops at its key."""
    table = (t4crs.TRAFFIC["table"] if plan == "Crs" else
             spec.load_cell("exp1-t0.csr").traffic["table"])
    got = two_way.expect(artifact_columns(t), {"b": 1}, {"table": table})
    assert got == _artifact_row(csv_name, plan)


#: ``expect`` on the small copies (data instance 0 of seed 2^31 + 77),
#: as the reference gave them before the no-early-exit branch came
SMALL_COUNTERS = {
    "exp1-t0.csr": {"matches": 16384, "cmps": 24583, "total": 16384},
    "exp1-t0.nrs": {"matches": 1024, "cmps": 1531, "total": 16384},
    "exp4-R24.ndu": {"rs": 1280, "rs_cmp": 4685, "rt": 256, "rt_cmp": 1366,
                     "unnest_t": 1024, "total": 4096},
    "exp1-dist4.nrs": {"matches": 2048, "cmps": 3049, "total": 32768},
}


@pytest.mark.parametrize("cell", sorted(SMALL_COUNTERS))
def test_the_small_copies_counters_stay(small_bench, cell):
    c = spec.load_cell(cell, small_bench)
    cols = spec.module("recipes", c.config["recipe"]).columns(
        c.config, instance_seed(2 ** 31 + 77, 0), CPU)
    ref = spec.module("references", c.traffic["reference"])
    assert ref.expect(cols, c.config, c.traffic) == SMALL_COUNTERS[cell]
