"""Seeds and generators: the port's stand-in for `jax.random` keys.

A key is a plain non-negative int. `fold_in(seed, t)` derives the seed
of slot t on the host (numpy's SeedSequence hashing, no device work), so
every random source is deterministic in (seed, t), as `fold_in` makes
the JAX sources, and `simulate` and `serve_loop` draw the same numbers.
The streams are not jax's threefry streams: tests that compare the two
packages feed both the same numpy-made tables instead.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def fold_in(seed: int, *data: int) -> int:
    """A new seed from `seed` and the ints `data` (e.g. a slot index)."""
    state = np.random.SeedSequence([int(seed) & _MASK63, *(int(x) for x in data)])
    return int(state.generate_state(1, np.uint64)[0]) & _MASK63


def split(seed: int, n: int) -> list:
    """`n` independent seeds, as `jax.random.split(key, n)` gives keys."""
    return [fold_in(seed, 0x5EED, i) for i in range(n)]


def generator(seed: int, device) -> torch.Generator:
    """A fresh generator on `device` seeded with `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
