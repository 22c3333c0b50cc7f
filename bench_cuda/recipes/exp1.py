"""Experiment 1's relations (``main_experiment1.cc:415-457`` of the 3D
hash join artifact, uniform keys): R.k a random permutation of the
``2^log2_card_r`` keys, S.a ``2^log2_card_s`` foreign keys drawn
uniformly from [0, 2^(log2_card_r - t)).  The artifact draws them with
``std::mt19937``; here a seeded ``torch.Generator`` on the card draws the
same distributions, so every seed gives the same sizes and domains.

Every key of the domain occurs in S.a, as in the artifact's own column
(numDvSa = 2^20 at -R 20 -S 24 -t 0): a plain uniform draw misses a key
of [0, 2^20) about one time in nine, and a miss sends the probe of R down
another path (its chain walk), so that the seed would change the work.
So, as the artifact generator's ``FLAG_FILL`` does, S.a holds every key
once and draws the rest uniformly, shuffled."""

from __future__ import annotations

import torch

from . import generator


def columns(config: dict, seed: int, device) -> dict:
    if config.get("skew"):
        raise ValueError("exp1 recipe: the zipf column is not drawn here")
    n_r = 1 << config["log2_card_r"]
    n_s = 1 << config["log2_card_s"]
    fk_max = 1 << (config["log2_card_r"] - config["t"])
    g = generator(seed, device)
    rk = torch.randperm(n_r, generator=g, device=device, dtype=torch.int32)
    if n_s < fk_max:
        sa = torch.randint(0, fk_max, (n_s,), generator=g, device=device,
                           dtype=torch.int32)
    else:
        sa = torch.cat([
            torch.arange(fk_max, dtype=torch.int32, device=device),
            torch.randint(0, fk_max, (n_s - fk_max,), generator=g,
                          device=device, dtype=torch.int32)])
        sa = sa[torch.randperm(n_s, generator=g, device=device)]
    return {"R": rk, "S": sa}


def small(config: dict) -> dict:
    """The keys a CPU copy of ``config`` overrides: 2^10 build keys (2^11
    over a mesh's ranks), S as many times larger than R as in ``config``,
    ``t`` kept; a mesh's ``key_domain`` and ``buckets_per_shard`` follow
    from the cut as they do at full size."""
    ranks = int(config.get("ranks", 1))
    log_r = min(config["log2_card_r"], 10 + (ranks > 1))
    log_s = log_r + config["log2_card_s"] - config["log2_card_r"]
    out = dict(log2_card_r=log_r, log2_card_s=log_s,
               rows={"R": 1 << log_r, "S": 1 << log_s})
    if "key_domain" in config:
        out["key_domain"] = 1 << (log_r - config["t"])
    if "buckets_per_shard" in config:
        out["buckets_per_shard"] = max((1 << log_r) // ranks // config["b"],
                                       1)
    return out
