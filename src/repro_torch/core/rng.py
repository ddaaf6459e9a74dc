"""Keys of the port's random sources: JAX's threefry keys.

Every entry point takes an int seed or a key (`repro_torch.random`'s
`[..., 2]` int64 tensor). An int seed means `PRNGKey(seed)`, as the JAX
package's benches call it, so a run draws JAX's streams. The keys are
derived once a run, on the device (`split(key, 3)`: carbon, arrivals,
policy), and a slot's draw folds in the slot index inside the draw
kernel (`kernels/threefry.py`; a run's loop draws its sources a block of
slots a launch), so the loop does no host work per slot.

The policy's key of slot t, `fold_in(k_policy, t)`, is handed over as a
`SlotKey`, and only a policy that draws folds it in (`RandomPolicy`, in
the same single launch as its draw); the others never compute it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as R


def key_of(key, device) -> torch.Tensor:
    """`PRNGKey(key)` for an int, else the key tensor on `device`."""
    if torch.is_tensor(key):
        if key.dtype != torch.int64 or key.shape[-1:] != (2,):
            raise ValueError(f"a key is an int64 [..., 2] tensor, got {key.dtype} "
                             f"{tuple(key.shape)}")
        return key if key.device == device else key.to(device)
    return R.PRNGKey(int(key), device=device)


class SlotKey(NamedTuple):
    """The key `fold_in(base, t)`, not yet computed."""

    base: torch.Tensor  # [..., 2]
    t: int


def draw_key(key, device) -> tuple:
    """(base key, slot or None) of a policy's `key` argument: a SlotKey,
    a key tensor or an int seed, for `ops.threefry_draw(base, t, ...)`."""
    if isinstance(key, SlotKey):
        return key.base, key.t
    return key_of(key, device), None
