"""Route-aware scheduling policies over a LinkGraph (counterpart of
`repro.network.policy`).

* NetworkAwareDPPPolicy -- drift-plus-penalty dispatch over the route
  lattice: each type goes to the route l minimizing

      rc[m,l] = V*Ct[l]*pt[m,l]                (transfer carbon, route l)
              + route_compute_weight * V*Cc[dest[l]]*pc[m,dest[l]]
              + Qt[m,l] + Qc[m,dest[l]]        (in-flight + dest drift)

  with the dispatch score b[m] = V*Ce*pe[m] + min_l rc[m,l] - Qe[m]
  feeding Algorithm 1's greedy fill. The Qt term prices a saturated
  route out. On `direct_graph` rc collapses bitwise onto the Qc row, so
  actions equal CarbonIntensityPolicy's (the regression anchor).

* StaticRoutePolicy -- transfer-blind adapter: any edge->cloud policy,
  its dispatches shipped down the graph's primary routes.

Both are called as policy(state, spec, Ce, Cc, arrivals, key, *, graph,
Qt, fault_view=None, deadline_view=None) with `graph` staged on the
state's device, and return a NetAction; both ignore the fault view (the
JAX package's are fault-blind too), and StaticRoute hands the deadline
view to its inner policy.
The state, spec, intensities, graph and Qt may carry a leading lane axis
(the WAN fleet: Qt [F, M, L], the graph from `stack_graphs`): each lane
gathers through its own dest, region and primary routes, and
`route_scores` takes all lanes in one launch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.policies import LookaheadDPPPolicy, _scalar
from repro_torch.core.queueing import NetworkSpec, NetworkState
from repro_torch.kernels import ops
from repro_torch.network.graph import LinkGraph
from repro_torch.network.transfer import NetAction, region_row
from repro_torch.telemetry.profile import phase


def _take(x, idx):
    """x read at `idx` along its last axis, `idx` [J] shared by every row
    or [..., J] with x's lanes (each lane its own indices) -> x.shape[:-1]
    + (J,)."""
    idx = idx.reshape(idx.shape[:-1] + (1,) * (x.dim() - idx.dim()) + idx.shape[-1:])
    return x.gather(-1, idx.expand(x.shape[:-1] + idx.shape[-1:]))


def _add_at(d, idx, L):
    """out[..., m, idx[..., n]] += d[..., m, n] for out [..., M, L]: the
    JAX package's `d @ one_hot(idx, L)`, exact for integral counts."""
    out = torch.zeros(d.shape[:-1] + (L,), dtype=d.dtype, device=d.device)
    return out.scatter_add_(-1, idx[..., None, :].expand(d.shape), d)


@dataclasses.dataclass(frozen=True)
class NetworkAwareDPPPolicy(LookaheadDPPPolicy):
    """Joint route + schedule DPP. V and the fill options come from
    CarbonIntensityPolicy, the horizon machinery from LookaheadDPPPolicy
    (H=1 here: myopic unless given a horizon and a forecast).

    route_compute_weight anticipates the destination's compute carbon
    at dispatch time. It defaults to 0 (strict DPP charges compute carbon
    when the cloud processes); a nonzero weight breaks the
    direct-graph parity by design. At 0 the score pass runs in the
    kernel's mode without `extra`, the rounding the JAX policy has
    inside its scan.
    """

    H: int = 1
    route_compute_weight: float = 0.0

    def _route_scores(self, state, Qt, graph, pe, pc, Ce, Cc, V):
        """Score pass over the route lattice: (rc [..., M, L], l1 [..., M],
        b [..., M]); a V of one value per lane scales its lane."""
        with phase("route_score"):
            Vl = V[..., None] if V.dim() else V
            VCt = Vl * region_row(graph, Ce, Cc)                  # [..., L]
            Qcr = _take(state.Qc, graph.dest)                     # [..., M, L]
            extra = None
            if self.route_compute_weight:
                pcr = _take(pc, graph.dest)
                VCc_dest = _take(Vl * Cc, graph.dest)
                extra = (_scalar(self.route_compute_weight, Qt.device)
                         * VCc_dest[..., None, :] * pcr)
            return ops.route_scores(Qt, graph.pt, Qcr, extra, state.Qe, pe, VCt, V * Ce)

    def __call__(self, state: NetworkState, spec: NetworkSpec, Ce, Cc, arrivals=None,
                 key=None, *, graph: LinkGraph, Qt, forecast=None, fault_view=None,
                 deadline_view=None) -> NetAction:
        del arrivals, key, fault_view, deadline_view
        Ce_eff, Cc_eff = self.effective_intensities(Ce, Cc, forecast)
        dev = state.Qc.device
        pe, pc, Pe, Pc = spec.as_arrays(dev)
        V = self._V(dev)
        # cloud half: Algorithm 1's c-matrix; edge half: each type onto
        # its best route; both fills in the parent's one stacked call
        c, _, _ = self._scores(state, pe, pc, Ce_eff, Cc_eff, V)
        _, l1, b = self._route_scores(state, Qt, graph, pe, pc, Ce_eff, Cc_eff, V)
        d_counts, w = self._fill_all(b, c, pe, pc, state.Qe, state.Qc, Pe, Pc)
        dt = torch.zeros_like(Qt).scatter_(-1, l1.long()[..., None], d_counts[..., None])
        return NetAction(dt=dt, w=w)


@dataclasses.dataclass(frozen=True)
class StaticRoutePolicy:
    """Transfer-blind adapter: `inner` decides (d, w) as if the clouds
    were attached directly, and every dispatch to cloud n rides the
    graph's primary route. Qt, bandwidth and link carbon are invisible
    to it."""

    inner: Callable

    def __call__(self, state: NetworkState, spec: NetworkSpec, Ce, Cc, arrivals=None,
                 key=None, *, graph: LinkGraph, Qt, forecast=None, fault_view=None,
                 deadline_view=None) -> NetAction:
        del Qt, fault_view  # the inner policy sees the fair-weather network
        kwargs = {} if forecast is None else {"forecast": forecast}
        if deadline_view is not None:
            kwargs["deadline_view"] = deadline_view
        act = self.inner(state, spec, Ce, Cc, arrivals, key, **kwargs)
        return NetAction(dt=_add_at(act.d, graph.primary, graph.L), w=act.w)
