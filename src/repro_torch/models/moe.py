"""Mixture-of-Experts layer (counterpart of `repro.models.moe`).

Two execution paths with the same routing:

* `moe_dense`    -- every expert on every token, the outputs weighed by
                    the router's top-k weights. Exact; the oracle the
                    SMOKE configs select.
* `moe_capacity` -- the production path: each (token, slot) pair takes a
                    position in its expert's buffer of C rows, pairs past
                    C are dropped, the experts run as batched products
                    over [E, C, D], and each token sums its kept slots'
                    outputs weighed by the router.

Routing (`_route`): float32 logits, padded experts at -inf, softmax, top
k, the k weights renormalised by max(sum, 1e-9). The shared experts and
Arctic's dense residual FFN are in `transformer.py`, as in the JAX
package. The expert-parallel `moe_ep_shardmap` (a mesh's all_to_all) is
not ported here: it belongs to the distributed slice.

Where the JAX package's numbers are integral the port gives its bits
(ROADMAP hazards 45-50):
* top-k takes a stable descending sort, so ties go to the lowest expert
  as `lax.top_k` sends them, and a padded expert (weight 0, after every
  real one) is never chosen;
* the softmax is `numerics.exp_xla` over logits - max, divided by the
  row's sum in XLA:CPU's order (`numerics.xla_sum`); given the same
  logits the weights are JAX's bits, but the logits' product sums in
  torch's order, so the weights meet JAX's within a tolerance;
* capacity, positions and drops (`dispatch_plan`) are computed as JAX
  computes them, so on the same routing they are JAX's exactly;
* the combine adds each token's slots in float32 from zero, slot 0
  first, each product rounded before its add, as XLA:CPU's scatter-add
  does (no fused multiply-add), then rounds to the input dtype. It
  gathers, and never scatter-adds: CUDA's atomic adds would sum in
  another order from run to run.

A dispatched row is copied into its buffer (JAX adds it to a zero
buffer, which also turns a -0.0 into +0.0: a product of the row cannot
tell them apart unless every term is zero).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.numerics import exp_xla, xla_sum
from repro_torch.models import layers as L


def padded_expert_count(n_experts: int, ep: int) -> int:
    """The experts padded to a multiple of the EP axis `ep`."""
    return int(math.ceil(n_experts / ep) * ep)


def init_moe(gen: torch.Generator, cfg, dtype):
    """Router [D, E] float32 (in a bf16 model too), w_in / w_gate [E, D,
    F] and w_out [E, F, D] in `dtype`, E the padded expert count."""
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    E = padded_expert_count(cfg.n_experts, cfg.ep_axis)
    p = {
        "router": L.dense_init(gen, (d, E), scale=0.02, dtype=torch.float32),
        "w_in": L.dense_init(gen, (E, d, ff), dtype=dtype),
        "w_out": L.dense_init(gen, (E, ff, d), scale=1.0 / math.sqrt(ff * 2 * cfg.n_layers),
                              dtype=dtype),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = L.dense_init(gen, (E, d, ff), dtype=dtype)
    return p


def _route(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] -> (weights [T, k] float32, idx [T, k] int64)."""
    return route_logits(x.float() @ p["router"].float(), cfg)


def route_logits(logits: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_route` from the router's float32 logits [T, E] (overwritten at
    the padded experts)."""
    if logits.shape[1] > cfg.n_experts:  # padded experts are never routed to
        logits[:, cfg.n_experts:] = -math.inf
    e = exp_xla(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / xla_sum(e[..., None])[..., None]
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.n_experts_active
    weights = top[:, :k]
    weights = weights / torch.clamp(xla_sum(weights[..., None]), min=1e-9)[..., None]
    return weights, idx[:, :k]


class DispatchPlan(NamedTuple):
    """Where each (token, slot) pair goes, pairs flattened token by token:
    expert `idx`, position `pos` in its buffer, `keep` = pos < C."""

    weights: torch.Tensor  # [T, k] float32
    idx: torch.Tensor      # [T, k] int64
    pos: torch.Tensor      # [T*k] int64
    keep: torch.Tensor     # [T*k] bool
    C: int                 # rows a buffer


def capacity(T: int, k: int, E: int, capacity_factor: float) -> int:
    """C = max(1, ceil(T*k*cf/E)), on the host as JAX computes it."""
    return int(max(1, math.ceil(T * k * capacity_factor / E)))


def dispatch_plan(weights: torch.Tensor, idx: torch.Tensor, E: int,
                  capacity_factor: float) -> DispatchPlan:
    """Places every (token, slot) pair of a routing (`_route`'s weights and
    idx [T, k] over E experts): its position is the count of earlier
    pairs (token by token, slot by slot) sent to the same expert, JAX's
    exclusive cumsum over a one-hot [T*k, E]. Here a stable sort by
    expert keeps each expert's pairs in that order, so a pair's position
    is its rank in its expert's run (torch.cumsum down the one-hot's
    columns took 51 ms a layer on an H100 at 131,072 pairs). Nothing is
    read on the host."""
    T, k = idx.shape
    flat_e = idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    by_expert = flat_e.index_select(0, order)
    rank = torch.arange(T * k, device=idx.device) - torch.searchsorted(by_expert, by_expert)
    pos = torch.empty_like(rank).scatter_(0, order, rank)
    C = capacity(T, k, E, capacity_factor)
    return DispatchPlan(weights, idx, pos, pos < C, C)


def _hidden(cfg, up: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    """The expert MLPs' hidden state from the up projection and, for a
    gated activation, the gate projection (None otherwise)."""
    if g is None:
        return L.gelu_tanh(up)
    return (L.silu(g) if cfg.activation == "swiglu" else L.gelu_tanh(g)) * up


def _expert_ffn(p, h: torch.Tensor, cfg, cd) -> torch.Tensor:
    """h [E, C, D] blocked per expert -> the expert MLPs' outputs [E, C, D].
    Each weight is cast to the compute dtype just before its product and
    dropped after it."""
    up = torch.bmm(h, p["w_in"].to(cd))
    g = torch.bmm(h, p["w_gate"].to(cd)) if "w_gate" in p else None
    return torch.bmm(_hidden(cfg, up, g), p["w_out"].to(cd))


def dispatch(xt: torch.Tensor, plan: DispatchPlan, E: int, cd) -> torch.Tensor:
    """The expert buffers [E, C, D] in the compute dtype: each kept pair's
    token row at (expert, position), zeros elsewhere. Kept (expert,
    position) pairs are unique, so the token ids are written to their
    slots (a dropped pair to a spare slot past the end) and the rows
    gathered once."""
    T, D = xt.shape
    k, C = plan.idx.shape[1], plan.C
    slot = torch.where(plan.keep, plan.idx.reshape(-1) * C + plan.pos, E * C)
    tok_of = torch.arange(T * k, device=xt.device) // k
    src = torch.full((E * C + 1,), T, dtype=torch.long, device=xt.device)  # T: the zero row
    src.index_put_((slot,), tok_of)
    rows = torch.cat([xt.to(cd), xt.new_zeros((1, D), dtype=cd)])
    return rows.index_select(0, src[:E * C]).view(E, C, D)


def combine(out_buf: torch.Tensor, plan: DispatchPlan, dtype) -> torch.Tensor:
    """out_buf [E, C, D] -> y [T, D] in `dtype`: y[t] = ((0 + g0*w0) +
    g1*w1) + ..., g_j the output row of token t's slot j (buffer row 0 of
    expert 0 for a dropped pair, whose weight is 0), w_j its weight,
    float32, each product rounded before its add."""
    E, C, D = out_buf.shape
    T, k = plan.idx.shape
    flat = out_buf.reshape(E * C, D)
    rows = (torch.where(plan.keep, plan.idx.reshape(-1) * C + plan.pos, 0)).view(T, k)
    w = (plan.weights.reshape(-1) * plan.keep.float()).view(T, k)
    y = torch.zeros((T, D), dtype=torch.float32, device=out_buf.device)
    for j in range(k):
        y = y + flat.index_select(0, rows[:, j]).float() * w[:, j, None]
    return y.to(dtype)


def moe_dense(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Exact MoE: every expert on every token (tiny configs only)."""
    B, S, D = x.shape
    cd = L.dtype_of(cfg.compute_dtype)
    T = B * S
    xt = x.reshape(T, D)
    weights, idx = _route(p, xt, cfg)
    E = p["router"].shape[1]
    up = torch.einsum("td,edf->tef", xt, p["w_in"].to(cd))
    g = torch.einsum("td,edf->tef", xt, p["w_gate"].to(cd)) if "w_gate" in p else None
    y_all = torch.einsum("tef,efd->ted", _hidden(cfg, up, g), p["w_out"].to(cd))  # [T, E, D]
    gate = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter_(1, idx, weights)
    y = torch.einsum("ted,te->td", y_all.float(), gate)
    return y.reshape(B, S, D).to(x.dtype)


def moe_capacity(p, x: torch.Tensor, cfg, *, capacity_factor: float = 1.25) -> torch.Tensor:
    """Capacity dispatch and combine: [B, S, D] -> T tokens -> top-k
    routes -> positions -> [E, C, D] buffers -> expert MLPs -> combine.
    A pair past its expert's C rows is dropped; its weight is not given
    to the others."""
    B, S, D = x.shape
    cd = L.dtype_of(cfg.compute_dtype)
    xt = x.reshape(B * S, D)
    E = p["router"].shape[1]
    plan = dispatch_plan(*_route(p, xt, cfg), E, capacity_factor)
    out_buf = _expert_ffn(p, dispatch(xt, plan, E, cd), cfg, cd)
    return combine(out_buf, plan, x.dtype).reshape(B, S, D)


def apply_moe(p, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.moe_path == "dense":
        return moe_dense(p, x, cfg)
    return moe_capacity(p, x, cfg, capacity_factor=cfg.moe_capacity_factor)
