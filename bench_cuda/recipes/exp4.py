"""Experiment 4's relations (``main_experiment4.cc:517-575`` of the 3D
hash join artifact): R.k the iota of ``2^log2_card_r`` keys; S.a and T.a
each hold the ``2^R >> alpha`` common foreign keys [0, nCommon)
``mult_alpha`` times and ``2^R >> beta`` exclusive ones ``mult_beta``
times -- S's [nCommon, nCommon + nExcl), T's the next nExcl values --
shuffled by a seeded permutation on the card (the artifact shuffles with
``std::mt19937``)."""

from __future__ import annotations

import torch

from . import generator


def cardinalities(config: dict) -> dict:
    """The recipe's derived sizes (``main_experiment4.cc:208-227``)."""
    n_r = 1 << config["log2_card_r"]
    common = n_r >> config["alpha"]
    excl = n_r >> config["beta"]
    fk = common * config["mult_alpha"] + excl * config["mult_beta"]
    return {"R": n_r, "S": fk, "T": fk, "common": common, "exclusive": excl,
            "key_domain": common + 2 * excl,
            "join_rs": fk, "join_rst": common * config["mult_alpha"] ** 2}


def columns(config: dict, seed: int, device) -> dict:
    c = cardinalities(config)
    common, excl = c["common"], c["exclusive"]
    g = generator(seed, device)

    def fk(lo: int) -> torch.Tensor:
        col = torch.cat([
            torch.arange(common, dtype=torch.int32,
                         device=device).repeat(config["mult_alpha"]),
            torch.arange(lo, lo + excl, dtype=torch.int32,
                         device=device).repeat(config["mult_beta"])])
        perm = torch.randperm(col.shape[0], generator=g, device=device)
        return col[perm]

    return {"R": torch.arange(c["R"], dtype=torch.int32, device=device),
            "S": fk(common), "T": fk(common + excl)}


def small(config: dict) -> dict:
    """The keys a CPU copy of ``config`` overrides: R cut to 2^12 keys,
    the multiplicities kept."""
    log_r = min(config["log2_card_r"], 12)
    c = cardinalities(dict(config, log2_card_r=log_r))
    return dict(log2_card_r=log_r, rows={k: c[k] for k in ("R", "S", "T")})
