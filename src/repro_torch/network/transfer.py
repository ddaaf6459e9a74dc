"""In-flight transfer dynamics over a LinkGraph (counterpart of
`repro.network.transfer`).

State is an aggregate pipe model per (task type, route):

  Qt   [M,L] -- tasks in flight (integral counts, float32)
  prog [M,L] -- transfer progress in size-units toward the in-flight
                pool (fractional; < size[m] once completed tasks leave)

Each slot a route drains up to bw[l] size-units, shared across task
types in proportion to their remaining work; a task lands in its
destination's Qc once a full size[m] of progress is booked against it.
So a lone task needs ceil(size/bw) slots, a backlogged route moves bw
size-units per slot, Qt changes only by integral dispatches and
deliveries, and bw = inf delivers everything in the same slot.

Rounding is the contract. Inside the JAX simulator's scan XLA:CPU
contracts `demand = Qt*size - prog`, `prog + demand*ratio` and the
residual `prog - delivered*size` into single-rounded FMAs, so all three
are `fma_f32` here, on the CPU and on the card. The per-route column
sum of `demand` runs in XLA:CPU's order on every device (`column_sum`),
which keeps the card's trajectory bitwise equal to the CPU's and both
bitwise equal to the JAX package's.

Every function takes a leading lane axis (the WAN fleet: Qt/prog/dt [F,
M, L], the graph from `graph.stack_graphs`): sums reduce each lane's own
axes, the column sum runs XLA:CPU's order per lane (which is what
`jit(vmap)` gives, hazard 20), and deliveries land through each lane's
own `dest`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.queueing import DTYPE, NetworkSpec, edge_energy
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.numerics import SUM_BLOCK, fma_f32
from repro_torch.network.graph import LinkGraph
from repro_torch.telemetry.profile import phase

_TINY = 1e-30  # drain-ratio denominator guard (no NaN even at bw=inf)


class LinkState(NamedTuple):
    Qt: torch.Tensor    # [M, L] tasks in flight per (type, route)
    prog: torch.Tensor  # [M, L] size-units transferred toward the pool


class NetAction(NamedTuple):
    """One slot of WAN scheduling: dt routes dispatches, w processes."""

    dt: torch.Tensor  # [M, L] tasks dispatched onto route l
    w: torch.Tensor   # [M, N] tasks processed at cloud n


def init_links(M: int, L: int, device=DEFAULT_DEVICE, dtype=DTYPE, F: int | None = None
               ) -> LinkState:
    """Empty links, [M, L] or, for F lanes, [F, M, L]."""
    dev = resolve_device(device)
    shape = (M, L) if F is None else (F, M, L)
    return LinkState(Qt=torch.zeros(shape, dtype=dtype, device=dev),
                     prog=torch.zeros(shape, dtype=dtype, device=dev))


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x, axis=-2) of an [..., M, L] tensor in XLA:CPU's order, per
    lane. While more than SUM_BLOCK rows remain, the rows are padded
    with zeros to a multiple of SUM_BLOCK, half the pad before and the
    rest after (`reduce-window` with `pad=lo_hi`, lo = pad // 2), and
    each window of SUM_BLOCK rows is summed in row order; the last <=
    SUM_BLOCK sums are then added in order. Every step is an elementwise
    float32 add, so the result is the same on every device: SUM_BLOCK - 1
    launches per window level plus one per final add (65 at M = 4096)."""
    while x.shape[-2] > SUM_BLOCK:
        pad = -x.shape[-2] % SUM_BLOCK
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
        blocks = x.reshape(x.shape[:-2] + (-1, SUM_BLOCK, x.shape[-1]))
        acc = blocks[..., 0, :]
        for i in range(1, SUM_BLOCK):
            acc = acc + blocks[..., i, :]
        x = acc
    acc = x[..., 0, :]
    for i in range(1, x.shape[-2]):
        acc = acc + x[..., i, :]
    return acc


def step_links(ls: LinkState, graph: LinkGraph, dt: torch.Tensor,
               bw_scale: torch.Tensor | None = None) -> Tuple[LinkState, torch.Tensor]:
    """Injects dt [..., M, L] new transfers, drains one slot of bandwidth
    and returns (next state, delivered [..., M, L] task counts). `graph`
    is staged on the device of `dt` (`LinkGraph.to`), with the lanes of
    `dt` when it has any.

    `bw_scale` [..., L] (the fault layer's link flaps) scales each
    route's bandwidth for this slot. The guarded `where` keeps a hard
    flap (scale 0) on an infinite-bandwidth route at exactly 0 instead
    of inf * 0 = NaN; a scale of 1.0 is a bitwise no-op."""
    with phase("transfer_step"):
        bw = graph.bw if bw_scale is None else torch.where(bw_scale > 0.0, graph.bw * bw_scale,
                                                           0.0)
        size = graph.size[..., :, None]
        Qt = ls.Qt + dt
        demand = fma_f32(Qt, size, -ls.prog)  # [..., M, L] work left
        total = column_sum(demand)            # [..., L]
        ratio = torch.clamp_max(bw / torch.clamp_min(total, _TINY), 1.0)
        prog = fma_f32(demand, ratio[..., None, :], ls.prog)
        # Clamp at 0 on both sides of the delivery: cancellation in
        # `prog - delivered*size` can leave prog at -eps, and
        # floor(-eps/size) = -1 would deliver a negative task. Where
        # prog >= 0 both clamps are exact no-ops.
        delivered = torch.minimum(Qt, torch.clamp_min(torch.floor(prog / size), 0.0))
        Qt = Qt - delivered
        prog = torch.clamp_min(fma_f32(-delivered, size, prog), 0.0)
        return LinkState(Qt=Qt, prog=prog), delivered


def land_in_clouds(delivered: torch.Tensor, graph: LinkGraph, N: int) -> torch.Tensor:
    """Aggregates route deliveries [..., M, L] into cloud arrivals [..., M,
    N]. The JAX module multiplies by a one-hot [L, N] matrix; a
    `scatter_add_` over each lane's `dest` is the same sum, exact for
    integral counts, and involves no matrix product that TF32 could
    round."""
    out = torch.zeros(delivered.shape[:-1] + (N,), dtype=delivered.dtype,
                      device=delivered.device)
    return out.scatter_add_(-1, graph.dest[..., None, :].expand(delivered.shape), delivered)


def transfer_energy(graph: LinkGraph, dt: torch.Tensor) -> torch.Tensor:
    """Per-route transfer energy of a dispatch action. Returns [..., L]."""
    return torch.sum(dt * graph.pt, dim=-2)


def region_row(graph: LinkGraph, Ce, Cc) -> torch.Tensor:
    """Each route's carbon intensity, the [..., N+1] row (Ce, Cc) read at
    `region`: [..., L]."""
    return torch.cat([Ce[..., None], Cc], dim=-1).gather(-1, graph.region)


def network_emissions(spec: NetworkSpec, graph: LinkGraph, action: NetAction, Ce, Cc) -> torch.Tensor:
    """End-to-end carbon of one slot (per lane): edge dispatch energy at
    the edge intensity, transfer energy priced in each route's carbon
    region (charged when the transfer starts), compute energy at the
    destination intensities."""
    pe, pc, _, _ = spec.as_arrays(action.dt.device)
    Ct = region_row(graph, Ce, Cc)  # [..., L]
    return (
        Ce * edge_energy(pe, action.dt)
        + torch.sum(Ct * transfer_energy(graph, action.dt), dim=-1)
        + torch.sum(Cc * torch.sum(action.w * pc, dim=-2), dim=-1)
    )
