"""Carries specs, states and link graphs between numpy, the JAX package
and the port.

`from_reference` reads a JAX `NetworkSpec` / `NetworkState`, and
`graph_from_reference` a JAX `LinkGraph`, by field names
(`np.asarray(obj.pe)`, ...), so the port never imports `repro`; the
parity tests use them to feed both packages the same numbers, and
`queues_numpy` to read both packages' recorded queues.
`key_from_reference` takes a JAX key's uint32 pair (`jax.random.key_data`),
`fleet_from_reference` a JAX `FleetScenario`'s arrays, as numpy,
`faults_from_reference` a JAX `FaultParams` and `deadlines_from_reference`
a JAX `DeadlineParams` (stacked or not).
`params_from_reference` and `cache_from_reference` carry an LM's
parameter and cache pytrees (nested dicts of arrays; a dense KV cache,
an enc-dec cache with its cross keys and values, or an SSM state cache)
over, leaf for leaf and bit for bit, bf16 included; `cache_to_numpy`
reads a cache back. `opt_state_from_reference` carries a JAX `AdamWState`
(m, v, step) over, so both packages can train from the same parameters
and optimizer state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.queueing import DTYPE, NetworkSpec, NetworkState
from repro_torch.core.simulator import FleetScenario, FleetSpec
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.network.graph import LinkGraph, make_graph, stack_graphs


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


def key_from_reference(key_u32, device=DEFAULT_DEVICE) -> torch.Tensor:
    """The port's key ([..., 2] int64) of a JAX key's uint32 data, e.g.
    `np.asarray(jax.random.key_data(k))` or a raw `PRNGKey` array."""
    a = np.asarray(key_u32)
    if a.dtype != np.uint32 or a.shape[-1:] != (2,):
        raise ValueError(f"key_from_reference: want uint32 [..., 2], got {a.dtype} {a.shape}")
    return torch.as_tensor(a.astype(np.int64), device=resolve_device(device))


def fleet_from_reference(fleet) -> FleetScenario:
    """The port's FleetScenario (numpy arrays) of a JAX FleetScenario,
    read by field names. A stacked JAX graph comes across lane by lane
    (each validated by `make_graph`, then `stack_graphs`), the
    forecast-error lanes as float32, a fault axis as the port's
    FaultParams and a deadline axis as its DeadlineParams, on the CPU."""
    f32 = lambda x: np.array(x, np.float32)  # noqa: E731
    deadlines = getattr(fleet, "deadlines", None)
    extra = {"deadlines": None if deadlines is None
             else deadlines_from_reference(deadlines, device="cpu")}
    faults = getattr(fleet, "faults", None)
    extra["faults"] = None if faults is None else faults_from_reference(faults, device="cpu")
    for f in ("err_bias", "err_noise"):
        extra[f] = None if getattr(fleet, f, None) is None else f32(getattr(fleet, f))
    g = getattr(fleet, "graph", None)
    if g is not None:
        fields = [np.asarray(getattr(g, f)) for f in LinkGraph._fields]
        extra["graph"] = stack_graphs(make_graph(*(x[i] for x in fields))
                                      for i in range(fields[0].shape[0]))
    return FleetScenario(
        spec=FleetSpec(*(f32(getattr(fleet.spec, f)) for f in FleetSpec._fields)),
        carbon=f32(fleet.carbon),
        arrival_amax=f32(fleet.arrival_amax),
        **extra,
    )


def faults_from_reference(faults, device=DEFAULT_DEVICE):
    """The port's FaultParams of a JAX FaultParams (one lane or stacked:
    numpy or jax leaves, link fields None or not), read by field names."""
    from repro_torch.faults import FaultParams

    return FaultParams(*(None if getattr(faults, f) is None
                         else np.array(getattr(faults, f), np.float32)
                         for f in FaultParams._fields)).to(device)


def deadlines_from_reference(deadlines, device=DEFAULT_DEVICE):
    """The port's DeadlineParams of a JAX DeadlineParams (one lane or
    stacked, numpy or jax leaves), read by field names."""
    from repro_torch.deadlines import DeadlineParams

    return DeadlineParams(*(np.array(getattr(deadlines, f), np.float32)
                            for f in DeadlineParams._fields)).to(device)


def queues_numpy(result) -> dict:
    """The recorded queue trajectories of a SimResult or NetSimResult of
    either package as numpy arrays: {"Qe", "Qc"} and, for a WAN run,
    "Qt"."""
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    names = ("Qe", "Qc", "Qt") if hasattr(result, "Qt") else ("Qe", "Qc")
    return {n: host(getattr(result, n)) for n in names}


def _leaf(x, device) -> torch.Tensor:
    """An array-like (numpy, or anything np.asarray reads, bf16 from
    ml_dtypes included) as a tensor of the same dtype and bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def params_from_reference(params, cfg, device=DEFAULT_DEVICE) -> dict:
    """The port's parameters from the JAX package's pytree of a dense, moe,
    ssm, vlm or enc-dec model (`Model(cfg).init(key)`), given as nested
    dicts of arrays: the same names, shapes (the stacked layer axis
    included; an enc-dec tree's "encoder" and "cross" stacks too, which
    must be there for an enc-dec config and only for one; a
    MoE layer's experts padded to a multiple of `ep_axis`), dtypes and
    bits (an SSM layer's A_log, D and dt_bias, and a MoE router, stay
    float32 in a bf16 model). A tied tree (tie_embeddings: PaliGemma,
    Qwen1.5-0.5B) has no "unembed" leaf, an untied one must have it."""
    from repro_torch.models.moe import padded_expert_count
    from repro_torch.models.transformer import require_ported

    require_ported(cfg)
    out = _tree(params, resolve_device(device))
    if tuple(out["embed"].shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"params_from_reference: embed {tuple(out['embed'].shape)} does not "
                         f"fit {cfg.name}")
    if ("unembed" in out) == cfg.tie_embeddings:
        raise ValueError(f"params_from_reference: {cfg.name} has tie_embeddings="
                         f"{cfg.tie_embeddings}, but the tree "
                         f"{'has' if 'unembed' in out else 'lacks'} an 'unembed' leaf")
    if ("encoder" in out or "cross" in out or cfg.is_encoder_decoder) and not (
            "encoder" in out and "cross" in out and cfg.is_encoder_decoder):
        raise ValueError(f"params_from_reference: {cfg.name} has is_encoder_decoder="
                         f"{cfg.is_encoder_decoder}, but the tree's stacks are "
                         f"{sorted(k for k in out if isinstance(out[k], dict))}")
    if cfg.n_experts:
        E = padded_expert_count(cfg.n_experts, cfg.ep_axis)
        router = out["layers"]["moe"]["router"]
        if tuple(router.shape) != (cfg.n_layers, cfg.d_model, E) or router.dtype != torch.float32:
            raise ValueError(f"params_from_reference: router {router.dtype} "
                             f"{tuple(router.shape)} does not fit {cfg.name} (float32 "
                             f"{(cfg.n_layers, cfg.d_model, E)}: {cfg.n_experts} experts padded "
                             f"to {E})")
    return out


def opt_state_from_reference(state, device=DEFAULT_DEVICE):
    """The port's `optim.AdamWState` from a JAX `AdamWState` (fields m, v:
    trees of float32 arrays shaped like the parameters; step: an int32
    scalar), leaf for leaf and bit for bit."""
    from repro_torch.optim import AdamWState

    dev = resolve_device(device)
    return AdamWState(m=_tree(state.m, dev), v=_tree(state.v, dev),
                      step=torch.full((), int(np.asarray(state.step)), dtype=torch.int32,
                                      device=dev))


def cache_from_reference(cache, device=DEFAULT_DEVICE) -> dict:
    """A cache from the JAX package's: a dense KV cache {"k", "v", "pos"}
    (an enc-dec one also "ck", "cv") with pos as a 0-d int32 tensor, or an
    SSM cache {"ssm", "conv"}."""
    dev = resolve_device(device)
    if "ssm" in cache:
        return {"ssm": _leaf(cache["ssm"], dev), "conv": _leaf(cache["conv"], dev)}
    out = {name: _leaf(cache[name], dev) for name in ("k", "v", "ck", "cv") if name in cache}
    out["pos"] = torch.full((), int(np.asarray(cache["pos"])), dtype=torch.int32, device=dev)
    return out


def cache_to_numpy(cache) -> dict:
    """A cache of either package as numpy: k, v (an enc-dec cache's ck,
    cv too; or ssm, conv) as float32, pos (for a KV cache) an int."""
    def host(x):
        if torch.is_tensor(x):
            return x.detach().float().cpu().numpy()
        return np.asarray(x, np.float32)

    if "ssm" in cache:
        return {"ssm": host(cache["ssm"]), "conv": host(cache["conv"])}
    out = {name: host(cache[name]) for name in ("k", "v", "ck", "cv") if name in cache}
    out["pos"] = int(np.asarray(cache["pos"].cpu() if torch.is_tensor(cache["pos"])
                                else cache["pos"]))
    return out
