"""Knapsack oracles for the per-slot surrogate (19), in PyTorch
(counterpart of `repro.core.knapsack`).

The paper shows minimizing (19) decouples into one unbounded knapsack per
resource (edge / each cloud), NP-hard in general. For validation:

  * exact_knapsack_min_py -- exact bounded-knapsack DP in numpy over an
    integral energy grid (weights rounded to a resolution). Ground truth
    for small instances; copied from the JAX package.
  * bounded_knapsack_min  -- the same DP on a fixed energy grid, the JAX
    package's rounding bitwise; `bounded_knapsack_min_batch` runs K of
    them in one call, which is how `ExactDPPPolicy` runs a slot's edge
    and cloud knapsacks. Both go through `kernels.ops.knapsack_dp`: one
    CUDA launch on the card, the plain forward DP on the CPU.

Items: take x_m in {0..cap_m} of type m, cost weight_m * x_m energy,
value score_m * x_m; minimize total value subject to energy <= budget.
Only negative scores can help, so positives are dropped up front.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops


def exact_knapsack_min_py(
    scores, weights, caps, budget, resolution: int = 2048
):
    """Exact bounded knapsack (minimization) on a discretized energy grid.

    Returns (counts [M], value). Weights are scaled so that `budget`
    maps to `resolution` grid cells; weights round UP (conservative:
    never violates the true budget).
    """
    scores = np.asarray(scores, np.float64)
    weights = np.asarray(weights, np.float64)
    caps = np.asarray(caps, np.float64)
    budget = float(budget)
    M = len(scores)
    if budget <= 0:
        return np.zeros(M), 0.0
    scale = resolution / budget
    iw = np.maximum(np.ceil(weights * scale - 1e-9).astype(int), 1)
    best = np.zeros(resolution + 1)  # best value at each used-energy level
    choice = [dict() for _ in range(resolution + 1)]
    # Bounded knapsack via binary splitting of counts.
    items = []  # (score, weight, type, multiplicity)
    for m in range(M):
        if scores[m] >= 0:
            continue
        cap = int(min(caps[m], budget // weights[m] if weights[m] > 0 else 0))
        k = 1
        while cap > 0:
            take = min(k, cap)
            items.append((scores[m] * take, iw[m] * take, m, take))
            cap -= take
            k *= 2
    for val, w, m, mult in items:
        if w > resolution:
            continue
        for e in range(resolution, w - 1, -1):
            cand = best[e - w] + val
            if cand < best[e] - 1e-12:
                best[e] = cand
                choice[e] = dict(choice[e - w])
                choice[e][m] = choice[e].get(m, 0) + mult
    e_star = int(np.argmin(best))
    counts = np.zeros(M)
    for m, c in choice[e_star].items():
        counts[m] = c
    return counts, float(best[e_star])


def bounded_knapsack_min_batch(scores, weights, caps, budget, grid: int = 512,
                               device=DEFAULT_DEVICE) -> torch.Tensor:
    """K knapsacks at once: [K, M] scores, weights and caps and a [K]
    budget -> integer counts [K, M] float32, each row the reference's
    `bounded_knapsack_min` of that row. One `knapsack_dp` launch on the
    card. Tensors stay on their device; host values go to `device`."""
    dev = scores.device if torch.is_tensor(scores) else resolve_device(device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    return ops.knapsack_dp(f32(scores), f32(weights), f32(caps), f32(budget), int(grid))


def bounded_knapsack_min(scores, weights, caps, budget, grid: int = 512,
                         device=DEFAULT_DEVICE) -> torch.Tensor:
    """Fixed-grid bounded-knapsack DP (minimization), the JAX package's
    signature: [M] scores, weights and caps and a budget -> integer
    counts [M] float32. Exact up to the grid discretization (weights
    rounded up), so the result is always feasible w.r.t. the true
    budget."""
    dev = scores.device if torch.is_tensor(scores) else resolve_device(device)
    row = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)[None]  # noqa: E731
    return bounded_knapsack_min_batch(row(scores), row(weights), row(caps),
                                      row(budget).reshape(1), grid)[0]
