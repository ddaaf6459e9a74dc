"""AdamW written functionally, as the JAX package writes it (counterpart
of `repro.optim.adamw`).

State = (m, v: float32 trees shaped like the parameters, step: a 0-d
int32 tensor). The update clips the gradients by their global norm, then
applies Adam with decoupled weight decay on every leaf, in float32, and
casts each parameter back to its dtype. `make_train_step` takes the
gradient of the model's loss with `torch.autograd.grad` with respect to
the parameter leaves and returns new trees; nothing is updated in place.

Scalars in JAX's rounding (ROADMAP hazards 62-63): the global norm sums
the leaves in `jax.tree.leaves` order (`pytree`); `b ** step` is taken in
float64 and rounded once, which gives the bias corrections 1 - b**step
bitwise as `jit` does for steps 0-1000 (XLA's float32 pow differs from it
only where it flushes a subnormal power to 0); `cosine_schedule` follows
the folded form `jit` compiles (the divisions by warmup and by the decay
span become products with float32 constants, `floor + 0.45 * (1 + cos)`
one FMA) with glibc's `cosf` (`numerics.sincos_glibc`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.numerics import fma_f32, sincos_glibc
from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def _f32(x) -> float:
    """x rounded to float32, as JAX rounds a weakly typed constant."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments (float32, each leaf's shape) and step 0, on the
        parameters' device."""
        leaves = tree_leaves(params)
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        return AdamWState(m=zeros, v=tree_map(torch.clone, zeros),
                          step=torch.zeros((), dtype=torch.int32, device=leaves[0].device))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), _f32(self.lr), dtype=torch.float32, device=step.device)

    def _bias_correction(self, b: float, step: torch.Tensor) -> torch.Tensor:
        """1 - b**step in float32, the power in float64 rounded once."""
        return 1.0 - torch.pow(torch.full((), _f32(b), dtype=torch.float64, device=step.device),
                               step.double()).float()

    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        """(params', state', {"grad_norm", "lr"}); grads and params are
        trees of the same structure."""
        flat_g = tree_leaves(grads)
        gsq = sum(torch.sum(torch.square(g.float())) for g in flat_g)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)

        step = state.step + 1
        b1, b2 = _f32(self.b1), _f32(self.b2)
        bc1, bc2 = self._bias_correction(self.b1, step), self._bias_correction(self.b2, step)
        lr = self._lr(step)
        c1, c2 = _f32(1 - self.b1), _f32(1 - self.b2)

        def upd(p, g, m, v):
            g = g.float() * scale
            m2 = b1 * m + c1 * g
            v2 = b2 * v + c2 * g * g
            delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + self.eps)
            pf = p.float()
            delta = delta + self.weight_decay * pf
            return (pf - lr * delta).to(p.dtype), m2, v2

        out = [upd(p, g, m, v) for p, g, m, v in zip(
            tree_leaves(params), flat_g, tree_leaves(state.m), tree_leaves(state.v))]
        return (tree_unflatten(params, [o[0] for o in out]),
                AdamWState(tree_unflatten(state.m, [o[1] for o in out]),
                           tree_unflatten(state.v, [o[2] for o in out]), step.to(torch.int32)),
                {"grad_norm": gnorm, "lr": lr})


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to peak_lr over `warmup` steps, then a cosine decay to
    floor * peak_lr at `total`: step (int tensor) -> float32 lr, bitwise
    `jit(repro.optim.adamw.cosine_schedule(...))` (module docstring)."""
    peak = _f32(peak_lr)
    warm_rate = _f32(np.float32(peak) * (np.float32(1) / np.float32(max(warmup, 1))))
    inv_span = _f32(np.float32(1) / np.float32(max(total - warmup, 1)))
    half = _f32((1 - floor) * 0.5)

    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        frac = torch.clamp((s - float(warmup)) * inv_span, 0.0, 1.0)
        _, cos = sincos_glibc(frac * _f32(math.pi))
        decay = fma_f32(cos + 1.0, half, _f32(floor)) * peak
        return torch.where(s < float(warmup), s * warm_rate, decay)

    return lr


def make_train_step(model, opt: AdamW):
    """train_step(params, opt_state, batch) -> (params', state', metrics):
    loss and gradients by autograd through `model.loss`, then
    `opt.update`. metrics: the loss's ({"loss", "tokens"}) plus
    "grad_norm" and "lr", detached tensors on the device (no host sync)."""

    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = model.loss(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        new_params, new_state, opt_metrics = opt.update(tree_unflatten(params, list(grads)),
                                                        opt_state, params)
        metrics = {k: v.detach() for k, v in dict(metrics, **opt_metrics, loss=loss).items()}
        return new_params, new_state, metrics

    return train_step
