"""The seeded generators: shapes, domains, multiplicities, and the same
data from the same seed."""

import json

import pytest
import torch

from bench_cuda import spec
from bench_cuda.recipes import exp1, exp4, instance_seed
from hashjoin3d_tpu_torch.models.exp4 import Cardinalities

CPU = torch.device("cpu")
EXP1 = dict(log2_card_r=10, log2_card_s=14, t=0, skew=False)


def test_instance_seeds_are_distinct_and_take_any_whole_number():
    seeds = {instance_seed(s, i) for s in (0, 7, 2 ** 31 + 5, 2 ** 70, -3)
             for i in range(4)}
    assert len(seeds) == 20
    assert instance_seed(2 ** 31 + 5, 1) == instance_seed(2 ** 31 + 5, 1)
    assert all(0 <= s < 2 ** 63 for s in seeds)


@pytest.mark.parametrize("t", [0, 4])
def test_exp1_permutation_and_domain(t):
    cols = exp1.columns(dict(EXP1, t=t), instance_seed(2 ** 31 + 9, 0), CPU)
    r, s = cols["R"], cols["S"]
    assert r.dtype == s.dtype == torch.int32
    assert torch.equal(torch.sort(r).values, torch.arange(1024,
                                                         dtype=torch.int32))
    assert s.numel() == 1 << 14
    assert int(s.min()) >= 0 and int(s.max()) < 1 << (10 - t)
    # uniform: every value of the domain turns up about as often, and
    # at least once
    counts = torch.bincount(s.long(), minlength=1 << (10 - t)).float()
    assert counts.std() / counts.mean() < 0.5
    assert int(counts.min()) >= 1


def test_exp1_same_seed_same_columns_other_seed_other():
    a = exp1.columns(EXP1, 11, CPU)
    b = exp1.columns(EXP1, 11, CPU)
    c = exp1.columns(EXP1, 12, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["S"], c["S"])


def test_exp1_refuses_the_zipf_column():
    with pytest.raises(ValueError):
        exp1.columns(dict(EXP1, skew=True), 1, CPU)


@pytest.mark.parametrize("shape", [(12, 4, 4, 2, 2), (12, 2, 3, 3, 1)])
def test_exp4_multiplicities_and_cardinalities(shape):
    lr, a, ma, b, mb = shape
    cfg = dict(log2_card_r=lr, alpha=a, mult_alpha=ma, beta=b, mult_beta=mb)
    card = Cardinalities.of(lr, a, ma, b, mb)
    c = exp4.cardinalities(cfg)
    assert (c["R"], c["S"], c["common"], c["exclusive"]) == (
        card.card_r, card.card_fk_relations, card.num_fk_common,
        card.num_fk_exclusive)
    assert c["join_rst"] == card.join_card2(ma)
    cols = exp4.columns(cfg, instance_seed(5, 0), CPU)
    assert torch.equal(cols["R"], torch.arange(card.card_r,
                                               dtype=torch.int32))
    nc, ne = card.num_fk_common, card.num_fk_exclusive
    for rel, lo in (("S", nc), ("T", nc + ne)):
        col = cols[rel]
        assert col.numel() == card.card_fk_relations
        cnt = torch.bincount(col.long(), minlength=nc + 2 * ne)
        assert torch.all(cnt[:nc] == ma)
        assert torch.all(cnt[lo:lo + ne] == mb)
        assert int(cnt.sum()) == col.numel()
        assert not torch.equal(col, torch.sort(col).values)  # shuffled
    # the result: every common key's S rows times its T rows
    cs = torch.bincount(cols["S"].long(), minlength=card.card_r)
    ct = torch.bincount(cols["T"].long(), minlength=card.card_r)
    assert int((cs * ct).sum()) == card.join_card2(ma)


def test_exp1_every_key_occurs_whatever_the_draw():
    """At 2^12 foreign keys over a 2^12 domain a plain uniform draw misses
    about a third of the keys; the recipe's column is then a
    permutation."""
    cfg = dict(log2_card_r=12, log2_card_s=12, t=0, skew=False)
    for seed in range(3):
        s = exp1.columns(cfg, seed, CPU)["S"]
        counts = torch.bincount(s.long(), minlength=1 << 12)
        assert int((counts == 0).sum()) == 0
        assert s.numel() == 1 << 12


#: the CPU copies as the tests wrote them out before the recipes cut them
SMALL = {
    "exp1-R20S24-t0": dict(log2_card_r=10, log2_card_s=14,
                           rows={"R": 1024, "S": 16384}),
    "exp4-R24": dict(log2_card_r=12, rows={"R": 4096, "S": 3072,
                                           "T": 3072}),
    "exp1-R22S26-t0-4ranks": dict(log2_card_r=11, log2_card_s=15,
                                  rows={"R": 2048, "S": 32768},
                                  key_domain=2048, buckets_per_shard=512),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_gives_the_copies_the_tests_had(name):
    cfg = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    assert spec.module("recipes", cfg["recipe"]).small(cfg) == SMALL[name]


def test_a_t4_copy_keeps_t():
    cfg = dict(json.loads((spec.HERE / "configs" / "exp1-R20S24-t0.json")
                          .read_text()), t=4)
    cut = dict(cfg, **exp1.small(cfg))
    assert (cut["log2_card_r"], cut["log2_card_s"], cut["t"]) == (10, 14, 4)
    s = exp1.columns(cut, instance_seed(3, 0), CPU)["S"]
    assert s.numel() == cut["rows"]["S"] == 64 * 256
    assert torch.unique(s).tolist() == list(range(64))
