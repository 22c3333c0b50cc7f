"""Experiment 1's relations under skew (``main_experiment1 --skew``,
``main_experiment1.cc:415-457`` of the 3D hash join artifact): R.k a
random permutation of the ``2^log2_card_r`` keys, as in :mod:`.exp1`, and
S.a ``2^log2_card_s`` foreign keys drawn zipf(1.0) over
[0, 2^(log2_card_r - t)): rank r (weight 1/r) is key r - 1.  The artifact
draws ranks by rejection-inversion (``util/zipf_distribution.hh``) from
``std::mt19937``; here a seeded ``torch.Generator`` on the card draws the
same distribution by inverse CDF: the float64 cumulative weights of the
ranks, one uniform float64 a row, and a binary search.  The weights are
summed on the host, in one fixed order: a scan on the card may add them
in another order from one call to the next, and a last bit that moves
there moves a draw to the next key, so that the check would redraw
another column than the one the window ran.  There is no fill, as in the
artifact's column: keys the draw misses have no S row."""

from __future__ import annotations

import torch

from . import generator
from .exp1 import small  # noqa: F401  (the CPU copies cut as exp-1's)


def columns(config: dict, seed: int, device) -> dict:
    n_r = 1 << config["log2_card_r"]
    n_s = 1 << config["log2_card_s"]
    fk_max = 1 << (config["log2_card_r"] - config["t"])
    g = generator(seed, device)
    rk = torch.randperm(n_r, generator=g, device=device, dtype=torch.int32)
    cdf = torch.cumsum(1.0 / torch.arange(1, fk_max + 1,
                                          dtype=torch.float64), 0)
    cdf = (cdf / cdf[-1]).to(device)
    u = torch.rand(n_s, generator=g, device=device, dtype=torch.float64)
    # the first rank whose cumulative weight passes u, counted from 0
    sa = torch.searchsorted(cdf, u, right=True, out_int32=True)
    return {"R": rk, "S": sa}
