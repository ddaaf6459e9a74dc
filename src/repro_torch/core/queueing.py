"""Virtual queueing network model (paper §III), in PyTorch.

Counterpart of `repro.core.queueing`. State is two float32 tensors:
  Qe  [M]    -- edge queue m: type-m tasks waiting at the edge server
  Qc  [M,N]  -- cloud queue (m,n): type-m tasks waiting at cloud n
An action is (d, w), both [M,N]: tasks dispatched edge -> cloud n
(eq. 1) and tasks processed at cloud n (eq. 2). Dynamics are eqs.
(7)-(8). Every function is a plain function on tensors and runs on
whatever device its inputs live on.

Every tensor may carry a leading lane axis (Qe [F, M], Qc [F, M, N], a
spec's pe [F, M], pc [F, M, N], Pe [F], Pc [F, N]): the JAX package's
`vmap` over fleet lanes written out. Sums run per lane, over the last
axes; a single-lane call is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

# Queue lengths are float32 on purpose, as in the JAX package: counts
# are integral by construction and exact up to 2**24.
DTYPE = torch.float32


class NetworkState(NamedTuple):
    """Virtual queueing network state at one time slot."""

    Qe: torch.Tensor  # [M]   edge queues
    Qc: torch.Tensor  # [M,N] cloud queues

    @property
    def M(self) -> int:
        return self.Qe.shape[-1]

    @property
    def N(self) -> int:
        return self.Qc.shape[-1]


class Action(NamedTuple):
    """A scheduling action for one time slot (d, w >= 0 integers)."""

    d: torch.Tensor  # [M,N] dispatch counts
    w: torch.Tensor  # [M,N] processing counts


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=DTYPE, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class NetworkSpec:
    """Static problem data (paper §II).

    Fields may be numpy arrays, Python floats or tensors:
      pe:  [M]   energy for the edge to send one type-m task (kWh)
      pc:  [M,N] energy for cloud n to process one type-m task (kWh)
      Pe:  scalar edge energy budget per slot (kWh)
      Pc:  [N]   per-cloud energy budget per slot (kWh)
    """

    pe: object
    pc: object
    Pe: object
    Pc: object

    @property
    def M(self) -> int:
        return self.pc.shape[-2]

    @property
    def N(self) -> int:
        return self.pc.shape[-1]

    def as_arrays(self, device=None):
        """(pe, pc, Pe, Pc) as float32 tensors on `device` (default: where
        `pc` already lives, else the CPU). A no-op for a spec that `to`
        already placed there."""
        if device is None:
            device = self.pc.device if torch.is_tensor(self.pc) else "cpu"
        return tuple(_as_f32(x, device) for x in (self.pe, self.pc, self.Pe, self.Pc))

    def to(self, device) -> "NetworkSpec":
        """A spec whose fields are float32 tensors on `device`. Loops call
        this once up front, so that no slot copies host data."""
        return NetworkSpec(*self.as_arrays(device))


def init_state(M: int, N: int, device=DEFAULT_DEVICE, dtype=DTYPE, F: int | None = None
               ) -> NetworkState:
    """Empty queues; with `F`, F lanes of them ([F, M], [F, M, N])."""
    dev = resolve_device(device)
    lanes = () if F is None else (int(F),)
    return NetworkState(
        Qe=torch.zeros(lanes + (M,), dtype=dtype, device=dev),
        Qc=torch.zeros(lanes + (M, N), dtype=dtype, device=dev),
    )


def edge_energy(spec_pe: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Total edge energy of a dispatch action (eq. 1), per lane."""
    return torch.sum(d * spec_pe[..., :, None], dim=(-2, -1))


def cloud_energy(spec_pc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-cloud energy of a processing action (eq. 2). Returns [..., N]."""
    return torch.sum(w * spec_pc, dim=-2)


def emissions(spec: NetworkSpec, action: Action, Ce, Cc) -> torch.Tensor:
    """Carbon emissions C(t) of an action (eq. 5), per lane.

    Ce: edge carbon intensity ([] or [F]); Cc: cloud intensities [..., N]."""
    pe, pc, _, _ = spec.as_arrays(action.d.device)
    return Ce * edge_energy(pe, action.d) + torch.sum(Cc * cloud_energy(pc, action.w), dim=-1)


def is_feasible(spec: NetworkSpec, action: Action, atol: float = 1e-3) -> torch.Tensor:
    """Checks energy constraints (3)-(4) and integrality/non-negativity
    (in every lane). Returns a 0-d bool tensor."""
    pe, pc, Pe, Pc = spec.as_arrays(action.d.device)
    ok_e = torch.all(edge_energy(pe, action.d) <= Pe + atol)
    ok_c = torch.all(cloud_energy(pc, action.w) <= Pc + atol)
    ok_nonneg = torch.all(action.d >= 0) & torch.all(action.w >= 0)
    ok_int = torch.all(action.d == torch.round(action.d)) & torch.all(
        action.w == torch.round(action.w)
    )
    return ok_e & ok_c & ok_nonneg & ok_int


def step(state: NetworkState, action: Action, arrivals: torch.Tensor) -> NetworkState:
    """One slot of queue dynamics, eqs. (7)-(8): departures are bounded by
    the current queue, arrivals land after service, and the full d lands
    in Qc (the paper's virtual-queue semantics)."""
    d_sum = torch.sum(action.d, dim=-1)  # [..., M]
    Qe = torch.clamp_min(state.Qe - d_sum, 0.0) + arrivals
    Qc = torch.clamp_min(state.Qc - action.w, 0.0) + action.d
    return NetworkState(Qe=Qe, Qc=Qc)


def lyapunov(state: NetworkState) -> torch.Tensor:
    """L(t) = 1/2 (sum Qe^2 + sum Qc^2), eq. (15), per lane."""
    return 0.5 * (torch.sum(state.Qe**2, dim=-1) + torch.sum(state.Qc**2, dim=(-2, -1)))


def drift_bound_B(spec: NetworkSpec, a_max, device=DEFAULT_DEVICE) -> torch.Tensor:
    """A constant B satisfying eq. (18) for all feasible actions (the
    worst cases of `repro.core.queueing.drift_bound_B`), on `device`."""
    pe, pc, Pe, Pc = spec.as_arrays(resolve_device(device))
    a_max = _as_f32(a_max, pe.device)
    d_row_max = Pe / pe  # [M]
    w_max = Pc[None, :] / pc  # [M,N]
    two_B = (
        torch.sum(a_max**2)
        + torch.sum(d_row_max**2)  # (sum_n d)^2 worst case
        + torch.sum(d_row_max**2)  # sum_n d^2 <= (sum_n d)^2
        + torch.sum(w_max**2)
    )
    return 0.5 * two_B
