"""Seeded data recipes, one module a recipe, named by a configuration's
``recipe`` key.  Each ``columns(config, seed, device)`` returns the
relations as int32 key carriers (u32 bits) made on ``device`` by a
``torch.Generator`` from ``seed``, in a few large calls, and
``small(config)`` returns the keys that a CPU copy of ``config`` (the
tests') overrides, ``rows`` included."""

from __future__ import annotations

import numpy as np
import torch


def instance_seed(seed: int, instance: int) -> int:
    """A 63-bit seed for data instance ``instance`` of run seed ``seed``
    (any whole number)."""
    ss = np.random.SeedSequence([abs(seed), int(seed < 0), instance])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
