"""Dense, MoE and SSM decoder stacks (counterpart of the dense, moe and
ssm parts of `repro.models.transformer`).

Parameters are nested dicts with the JAX package's names, and the layer
stack keeps its leading layer axis ([L, ...] per leaf), so
`convert.params_from_reference` maps a JAX pytree onto them leaf for
leaf. Where the JAX package scans over the layer axis, the port loops
over it in Python. There is no rematerialisation: this is the inference
path. A MoE layer's FFN is `moe.apply_moe` plus the always-on shared
MLP and Arctic's parallel dense residual MLP (`_apply_ffn`). Hybrid,
VLM and enc-dec stacks, MoE on every other layer (`moe_every` 2, which
only the hybrid Jamba uses), and the training loss are later slices
(ROADMAP Queue 1, next slices 3).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe


def require_ported(cfg) -> None:
    """Admits the families the port serves, dense, moe (MoE on every
    layer) and ssm; raises NotImplementedError for the rest."""
    if cfg.n_experts and cfg.moe_every > 1 and cfg.family in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: MoE every {cfg.moe_every} layers is not ported to repro_torch yet; the "
            "JAX package stacks such layers in pairs, which only the hybrid family uses "
            "(ROADMAP Queue 1, next slices 3.3)")
    ported = cfg.family in ("dense", "moe", "ssm")
    if not ported or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to repro_torch yet "
            "(ROADMAP Queue 1, next slices 3); the port serves the dense, moe and ssm families")


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of a stacked parameter tree, as views."""
    return tree_map(lambda t: t[i], stacked)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_ffn(gen, cfg, dtype):
    """A dense MLP, or MoE (+ the shared MLP, + the dense residual MLP)."""
    if not cfg.n_experts:
        return {"mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, cfg.n_layers,
                                  dtype)}
    p = {"moe": moe.init_moe(gen, cfg, dtype)}
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, cfg.d_model,
                                 (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts,
                                 cfg.activation, cfg.n_layers, dtype)
    if cfg.moe_dense_residual:
        p["dense_res"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, cfg.n_layers,
                                    dtype)
    return p


def _init_dense_layer(gen, cfg, dtype):
    p = {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
        "attn": L.init_attention(gen, cfg, dtype),
        "ln2": L.init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
    }
    p.update(_init_ffn(gen, cfg, dtype))
    return p


def _init_ssm_layer(gen, cfg, dtype):
    return {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
        "mamba": mamba2.init_ssm_layer(gen, cfg, dtype),
    }


def _stack(make, n: int):
    """n trees from `make()` stacked on a new leading axis, filled one
    layer at a time (the peak is the stack plus one layer, not two
    stacks)."""
    first = make()
    if n == 1:  # a view: no second copy of the layer
        return tree_map(lambda t: t.unsqueeze(0), first)
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)

    def put(dst, src, i):
        for key, val in src.items():
            if isinstance(val, dict):
                put(dst[key], val, i)
            else:
                dst[key][i].copy_(val)

    put(out, first, 0)
    for i in range(1, n):
        put(out, make(), i)
    return out


def init_params(gen: torch.Generator, cfg) -> Dict[str, Any]:
    """Random parameters on the generator's device (the port's own
    init: torch's normals, not jax.random's)."""
    require_ported(cfg)
    dtype = L.dtype_of(cfg.param_dtype)
    p: Dict[str, Any] = {
        "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                    scale=1.0 / math.sqrt(cfg.d_model), dtype=dtype)
    init_layer = _init_ssm_layer if cfg.family == "ssm" else _init_dense_layer
    p["layers"] = _stack(lambda: init_layer(gen, cfg, dtype), cfg.n_layers)
    return p


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _apply_ffn(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The layer's FFN on x (p: the layer's parameters). A MoE layer adds
    moe + shared, then + dense_res, each sum rounded to x's dtype, as the
    JAX package does before its residual add."""
    if "mlp" in p:
        return L.apply_mlp(p["mlp"], x, cfg.activation, cfg.compute_dtype)
    y = moe.apply_moe(p["moe"], x, cfg)
    if "shared" in p:
        y = y + L.apply_mlp(p["shared"], x, cfg.activation, cfg.compute_dtype)
    if "dense_res" in p:
        y = y + L.apply_mlp(p["dense_res"], x, cfg.activation, cfg.compute_dtype)
    return y


def _dense_block(x, lp, cfg, rope, mask_mode, prefix_len):
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    y = L.gqa_attention(lp["attn"], h, cfg, rope, mask_mode=mask_mode, prefix_len=prefix_len)
    x, h = L.residual_norm(lp["ln2"], x, y, cfg.norm)
    return x + _apply_ffn(lp, h, cfg)


def _ssm_block(x, lp, cfg):
    h = L.apply_norm(lp["ln1"], x, cfg.norm)
    return x + mamba2.mamba_forward(lp["mamba"], h, cfg)


def backbone(params, x: torch.Tensor, cfg, *, mask_mode="causal", prefix_len=0):
    """Runs the decoder stack on embedded inputs x [B,S,D]."""
    require_ported(cfg)
    S = x.shape[1]
    rope = None if cfg.family == "ssm" else L.rope_tables(cfg, torch.arange(S, device=x.device), S)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        if cfg.family == "ssm":
            x = _ssm_block(x, lp, cfg)
        else:
            x = _dense_block(x, lp, cfg, rope, mask_mode, prefix_len)
    return L.apply_norm(params["final_norm"], x, cfg.norm)


def _unembed_weight(params, cfg) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]  # [D, V]
