"""Carries specs, states and link graphs between numpy, the JAX package
and the port.

`from_reference` reads a JAX `NetworkSpec` / `NetworkState`, and
`graph_from_reference` a JAX `LinkGraph`, by field names
(`np.asarray(obj.pe)`, ...), so the port never imports `repro`; the
parity tests use them to feed both packages the same numbers, and
`queues_numpy` to read both packages' recorded queues.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.queueing import DTYPE, NetworkSpec, NetworkState
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.network.graph import LinkGraph, make_graph


def _t(x, device) -> torch.Tensor:
    # np.array copies: a JAX array's host view is read-only
    return torch.as_tensor(np.array(x, np.float32), dtype=DTYPE, device=device)


def spec_from_numpy(pe, pc, Pe, Pc, device=DEFAULT_DEVICE) -> NetworkSpec:
    """A NetworkSpec of float32 tensors on `device`."""
    dev = resolve_device(device)
    return NetworkSpec(pe=_t(pe, dev), pc=_t(pc, dev), Pe=_t(Pe, dev), Pc=_t(Pc, dev))


def state_from_numpy(Qe, Qc, device=DEFAULT_DEVICE) -> NetworkState:
    """A NetworkState of float32 tensors on `device`."""
    dev = resolve_device(device)
    return NetworkState(Qe=_t(Qe, dev), Qc=_t(Qc, dev))


def from_reference(obj, device=DEFAULT_DEVICE):
    """The port's twin of a JAX NetworkSpec (fields pe, pc, Pe, Pc) or
    NetworkState (fields Qe, Qc), found by duck typing."""
    if all(hasattr(obj, f) for f in ("pe", "pc", "Pe", "Pc")):
        return spec_from_numpy(obj.pe, obj.pc, obj.Pe, obj.Pc, device)
    if all(hasattr(obj, f) for f in ("Qe", "Qc")):
        return state_from_numpy(obj.Qe, obj.Qc, device)
    raise TypeError(f"from_reference: {type(obj).__name__} is neither a spec nor a state")


def graph_from_numpy(dest, bw, pt, region, size, primary, device=DEFAULT_DEVICE) -> LinkGraph:
    """A validated LinkGraph (`network.make_graph`) staged on `device`."""
    return make_graph(dest, bw, pt, region, size, primary).to(resolve_device(device))


def graph_from_reference(graph, device=DEFAULT_DEVICE) -> LinkGraph:
    """The port's twin of a JAX LinkGraph, read by its field names."""
    return graph_from_numpy(*(np.asarray(getattr(graph, f)) for f in LinkGraph._fields),
                            device=device)


def queues_numpy(result) -> dict:
    """The recorded queue trajectories of a SimResult or NetSimResult of
    either package as numpy arrays: {"Qe", "Qc"} and, for a WAN run,
    "Qt"."""
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    names = ("Qe", "Qc", "Qt") if hasattr(result, "Qt") else ("Qe", "Qc")
    return {n: host(getattr(result, n)) for n in names}
