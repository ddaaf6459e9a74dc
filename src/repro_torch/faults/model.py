"""Fault processes for the queueing network (counterpart of
`repro.faults.model`).

Four orthogonal fault axes, each a per-slot stochastic process whose
state the slot loop carries (every leaf may carry a leading lane axis,
so a fleet runs a fault scenario per lane in the same launches):

  * cloud outages      -- a per-cloud Markov on/off chain (p_down/p_up)
    plus a scheduled blackout window (sched_start/sched_len, in slots);
  * brownouts          -- a second per-cloud chain that scales the
    cloud's energy budget by `brown_floor` while active;
  * link flaps         -- a per-route chain scaling link bandwidth by
    `link_floor` while down (0 = hard flap), for WAN runs;
  * telemetry dropouts -- a chain on the carbon feed: while down the
    policy sees the last good intensity row and a staleness counter;
    emissions are always accounted at the true intensities;
  * task failures      -- each processed task fails with `task_p_fail`
    at its cloud and re-enters through a bounded exponential-backoff
    retry pool.

Integral task counts come from stochastic rounding, floor(x + U) with U
uniform on [0, 1): integral, mean-exact, never above the integral pool
it draws from.

The slot's uniforms are JAX's streams: from `fold_in(k_fault, t)`,
children (0, 0)-(0, 4) of `split(k, 2)[0]`'s five-way split (clouds,
brownouts, telemetry, links, retry release) and child (1,) (failures).
`fault_draws` takes all six in one `ops.threefry_draw(paths=...)`
launch at the start of the slot, for every lane.

Rounding follows XLA:CPU inside the simulator's scan: the release rate
is `jnp.exp2`, which XLA compiles to exp(x * 0.6931472) with its own
float32 exp (`numerics.exp2_xla`; not exact at integers from 13 on), and
both stochastic roundings floor(a * p + U) are one FMA
(`numerics.fma_f32`).

The zero-fault anchor: with `no_faults(...)` every chain stays up and
every mask is an exact 1.0 / +0.0, so the faulted loop reduces to
bitwise identities of the fault-free one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.numerics import exp2_xla, fma_f32
from repro_torch.telemetry.profile import phase

# Salt of the fault stream: fold_in(key, FAULT_STREAM_SALT) leaves the
# (carbon, arrival, policy) streams of split(key, 3) as they are.
FAULT_STREAM_SALT = 7

_F32 = torch.float32


class FaultParams(NamedTuple):
    """Fault-process rates, float32 tensors ([F, ...] on a fleet's lane
    axis); the three link fields are None without a LinkGraph."""

    cloud_p_down: torch.Tensor   # [N] P(up -> down) per slot
    cloud_p_up: torch.Tensor     # [N] P(down -> up) per slot
    brown_p_start: torch.Tensor  # [N] P(enter brownout)
    brown_p_end: torch.Tensor    # [N] P(exit brownout)
    brown_floor: torch.Tensor    # [N] capacity factor while browned, in (0, 1]
    sched_start: torch.Tensor    # [N] scheduled blackout start slot
    sched_len: torch.Tensor      # [N] scheduled blackout length (0 = none)
    task_p_fail: torch.Tensor    # [N] per-task failure probability at cloud n
    backoff_max: torch.Tensor    # [] max retry backoff level (release ~ 2^-lvl)
    telem_p_down: torch.Tensor   # [] P(carbon feed drops)
    telem_p_up: torch.Tensor     # [] P(carbon feed recovers)
    link_p_down: torch.Tensor | None = None  # [L] P(link flaps down)
    link_p_up: torch.Tensor | None = None    # [L] P(link recovers)
    link_floor: torch.Tensor | None = None   # [L] bw factor while flapped

    def to(self, device) -> "FaultParams":
        """Every leaf as a float32 tensor on `device` (numpy leaves too)."""
        dev = resolve_device(device)

        def leaf(x):
            if x is None:
                return None
            if not torch.is_tensor(x):
                x = torch.from_numpy(np.asarray(x, np.float32))
            return x.to(device=dev, dtype=_F32)
        return FaultParams(*(leaf(x) for x in self))


class FaultState(NamedTuple):
    """The slot loop's fault carry."""

    cloud_up: torch.Tensor   # [N] bool outage chain
    browned: torch.Tensor    # [N] bool brownout chain
    telem_up: torch.Tensor   # []  bool telemetry chain
    last_row: torch.Tensor   # [N+1] float32 last good intensity row
    stale: torch.Tensor      # []  int32 slots since a fresh carbon reading
    retry: torch.Tensor      # [M, N] float32 failed tasks awaiting requeue
    backoff: torch.Tensor    # [N] int32 retry backoff level
    link_up: torch.Tensor | None = None  # [L] bool link chain


class FaultView(NamedTuple):
    """What one slot of fault state shows the policy and the simulator."""

    obs_row: torch.Tensor    # [N+1] observed (possibly stale) intensity row
    stale: torch.Tensor      # []  int32 staleness of obs_row
    cloud_cap: torch.Tensor  # [N] capacity factor (0 down, brown_floor, or 1)
    cloud_on: torch.Tensor   # [N] 1.0 where the cloud can process at all
    released: torch.Tensor   # [M, N] retry tasks re-entering Qc this slot
    bw_scale: torch.Tensor | None = None  # [L] bandwidth factor (1.0 = clean)
    link_on: torch.Tensor | None = None   # [L] 1.0 where the route is usable


class FaultDraws(NamedTuple):
    """A slot's fault uniforms, views into one draw."""

    cloud: torch.Tensor  # [..., N]
    brown: torch.Tensor  # [..., N]
    telem: torch.Tensor  # [...]
    link: torch.Tensor | None  # [..., L]
    rel: torch.Tensor    # [..., M, N]
    fail: torch.Tensor   # [..., M, N]


def no_faults(N: int, L: int | None = None, device=DEFAULT_DEVICE) -> FaultParams:
    """All rates zero, all floors 1.0: the bitwise-parity anchor."""
    dev = resolve_device(device)
    z = torch.zeros((N,), dtype=_F32, device=dev)
    o = torch.ones((N,), dtype=_F32, device=dev)
    s = torch.zeros((), dtype=_F32, device=dev)
    link = lambda v: None if L is None else torch.full((L,), v, dtype=_F32, device=dev)  # noqa: E731
    return FaultParams(
        cloud_p_down=z, cloud_p_up=z, brown_p_start=z, brown_p_end=z, brown_floor=o,
        sched_start=z, sched_len=z, task_p_fail=z,
        backoff_max=torch.full((), 6.0, dtype=_F32, device=dev),
        telem_p_down=s, telem_p_up=s,
        link_p_down=link(0.0), link_p_up=link(0.0), link_floor=link(1.0),
    )


def make_faults(N: int, L: int | None = None, device=DEFAULT_DEVICE, **overrides) -> FaultParams:
    """`no_faults` with per-field overrides, scalars broadcast to the
    field's shape: the one constructor scenario builders and tests use,
    so shapes and dtypes cannot drift."""
    base = no_faults(N, L, device)
    bad = set(overrides) - set(FaultParams._fields)
    if bad:
        raise ValueError(f"unknown FaultParams fields: {sorted(bad)}")
    missing = [k for k in overrides if getattr(base, k) is None]
    if missing:
        raise ValueError(
            f"link fault fields {missing} need L (got L=None): pass the route count when "
            "building faults for a LinkGraph run")
    dev = base.cloud_p_down.device
    cast = {}
    for k, v in overrides.items():
        x = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v, np.float32))
        cast[k] = torch.broadcast_to(x.to(device=dev, dtype=_F32),
                                     getattr(base, k).shape).clone()
    return base._replace(**cast)


def stack_faults(params) -> FaultParams:
    """Per-lane FaultParams stacked onto a leading fleet axis (the link
    fields None in every lane or in none)."""
    params = list(params)
    out = []
    for i in range(len(FaultParams._fields)):
        leaves = [p[i] for p in params]
        if any(x is None for x in leaves):
            if not all(x is None for x in leaves):
                raise ValueError("stack_faults: link fields are None in some lanes only")
            out.append(None)
        else:
            out.append(torch.stack([torch.as_tensor(x, dtype=_F32) for x in leaves]))
    return FaultParams(*out)


def init_faults(M: int, N: int, L: int | None = None, device=DEFAULT_DEVICE,
                F: int | None = None) -> FaultState:
    """Every chain up, nothing stale, an empty retry pool; with `F`, F
    lanes of it."""
    dev = resolve_device(device)
    lanes = () if F is None else (int(F),)
    return FaultState(
        cloud_up=torch.ones(lanes + (N,), dtype=torch.bool, device=dev),
        browned=torch.zeros(lanes + (N,), dtype=torch.bool, device=dev),
        telem_up=torch.ones(lanes, dtype=torch.bool, device=dev),
        last_row=torch.zeros(lanes + (N + 1,), dtype=_F32, device=dev),
        stale=torch.zeros(lanes, dtype=torch.int32, device=dev),
        retry=torch.zeros(lanes + (M, N), dtype=_F32, device=dev),
        backoff=torch.zeros(lanes + (N,), dtype=torch.int32, device=dev),
        link_up=None if L is None else torch.ones(lanes + (L,), dtype=torch.bool, device=dev),
    )


def fault_paths(M: int, N: int, L: int | None = None) -> tuple:
    """The draw's segments of one fault slot, ((path, length), ...),
    from fold_in(k_fault, t): k_step = child 0, split five ways (clouds,
    brownouts, telemetry, links, release), k_fail = child 1. Without
    links the link segment is left out (JAX splits it off and draws
    nothing from it)."""
    segs = [((0, 0), N), ((0, 1), N), ((0, 2), 1)]
    if L is not None:
        segs.append(((0, 3), L))
    segs += [((0, 4), M * N), ((1,), M * N)]
    return tuple(segs)


def fault_draws(k_fault: torch.Tensor, t: int, M: int, N: int, L: int | None = None
                ) -> FaultDraws:
    """The slot's six fault uniforms, every lane in one draw launch."""
    paths = fault_paths(M, N, L)
    n = sum(length for _, length in paths)
    u = ops.threefry_draw(k_fault, t, n, paths=paths)
    lanes = tuple(u.shape[:-1])
    parts = list(torch.split(u, [length for _, length in paths], dim=-1))
    link = parts.pop(3) if L is not None else None
    cloud, brown, telem, rel, fail = parts
    return FaultDraws(cloud=cloud, brown=brown, telem=telem[..., 0], link=link,
                      rel=rel.reshape(lanes + (M, N)), fail=fail.reshape(lanes + (M, N)))


def _stoch_round(x: torch.Tensor, p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """floor(x * p + u), the product and the add one FMA as XLA:CPU
    contracts them: integral, mean-exact, at most the pool x (u < 1)."""
    return torch.floor(fma_f32(x, p, u))


def _markov(up: torch.Tensor, u: torch.Tensor, p_down, p_up) -> torch.Tensor:
    """One step of a two-state chain: a state that holds stays unless u <
    p_down, one that does not comes when u < p_up."""
    return torch.where(up, u >= p_down, u < p_up)


def step_faults(fs: FaultState, fp: FaultParams, t: int, u: FaultDraws,
                true_row: torch.Tensor):
    """Advances every fault chain one slot and builds the slot's view:
    chains transition first (a cloud that drops at slot t is already
    unavailable to slot t's policy), telemetry freezes or refreshes the
    observed row, then the retry pool releases floor(retry * 2^-backoff
    * on + U) tasks per (type, cloud) toward Qc, gated on the cloud being
    up. Returns (next state, FaultView)."""
    with phase("fault_step"):
        cloud_up = _markov(fs.cloud_up, u.cloud, fp.cloud_p_down, fp.cloud_p_up)
        # a brownout holds while u >= p_end and starts when u < p_start
        browned = _markov(fs.browned, u.brown, fp.brown_p_end, fp.brown_p_start)
        tf = torch.full((), float(t), dtype=_F32, device=true_row.device)
        sched_down = (tf >= fp.sched_start) & (tf < fp.sched_start + fp.sched_len)
        cloud_cap = torch.where(sched_down | ~cloud_up, 0.0,
                                torch.where(browned, fp.brown_floor, 1.0))
        cloud_on = (cloud_cap > 0.0).to(_F32)
        telem_up = _markov(fs.telem_up, u.telem, fp.telem_p_down, fp.telem_p_up)
        obs_row = torch.where(telem_up[..., None], true_row, fs.last_row)
        stale = torch.where(telem_up, 0, fs.stale + 1).to(torch.int32)
        if fp.link_p_down is not None:
            link_up = _markov(fs.link_up, u.link, fp.link_p_down, fp.link_p_up)
            bw_scale = torch.where(link_up, 1.0, fp.link_floor)
            link_on = (bw_scale > 0.0).to(_F32)
        else:
            link_up = bw_scale = link_on = None
        rate = exp2_xla(-fs.backoff.to(_F32))  # [..., N]
        released = _stoch_round(fs.retry, (rate * cloud_on)[..., None, :], u.rel)
        nxt = FaultState(cloud_up=cloud_up, browned=browned, telem_up=telem_up,
                         last_row=obs_row, stale=stale, retry=fs.retry - released,
                         backoff=fs.backoff, link_up=link_up)
        view = FaultView(obs_row=obs_row, stale=stale, cloud_cap=cloud_cap, cloud_on=cloud_on,
                         released=released, bw_scale=bw_scale, link_on=link_on)
        return nxt, view


def requeue_failed(fs: FaultState, fp: FaultParams, w_eff: torch.Tensor, u_fail: torch.Tensor):
    """Draws per-(type, cloud) task failures out of this slot's effective
    processing `w_eff [..., M, N]`, banks them in the retry pool and
    moves the backoff level: up on any failure at the cloud, one step
    down on a clean slot (bounded by `backoff_max`). Returns (next
    state, failed [..., M, N])."""
    with phase("fault_retry"):
        failed = _stoch_round(w_eff, fp.task_p_fail[..., None, :], u_fail)
        fail_n = torch.sum(failed, dim=-2)
        bmax = fp.backoff_max.to(torch.int32)[..., None]
        backoff = torch.where(fail_n > 0.0, torch.minimum(fs.backoff + 1, bmax),
                              torch.clamp_min(fs.backoff - 1, 0)).to(torch.int32)
        return fs._replace(retry=fs.retry + failed, backoff=backoff), failed
