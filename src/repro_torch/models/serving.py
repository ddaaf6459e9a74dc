"""Serving entry points for the dense, moe and ssm families (counterpart
of `repro.models.serving`): prefill (build the cache) and one-token
decode. The moe family serves through the dense path, its layers' FFN
that of JAX's `_ffn_sub` (`transformer._apply_ffn`).

Caches:
  dense, moe: {"k" [L,B,C,K,hd], "v" [L,B,C,K,hd] in the compute dtype, "pos"
         a 0-d int32 tensor on the device}, C the cache capacity. The
         cache holds the rotated keys.
  ssm:   {"ssm" [L,B,H,N,P] float32, "conv" [L,B,W-1,C] in the compute
         dtype}: fixed size, no position (a prefill's cache_len is not
         read).
`decode_step` writes the dense step's k/v, and the ssm step's states, IN
PLACE into the cache it is given (the JAX function returns new arrays);
the dense step returns a new "pos". Nothing in a step reads device data
on the host. Every other family raises NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models.transformer import (
    _apply_ffn,
    _unembed_weight,
    layer,
    require_ported,
)


def _logits(params, x_last: torch.Tensor, cfg) -> torch.Tensor:
    """[B,D] -> [B,V] float32: a float32 product with the unembedding, as
    the JAX package takes it. The eager `w.float()` copies the whole
    unembedding each call (2.5 GB at GLM-4-9B's vocab): exact, and costed
    in PERF.md."""
    w = _unembed_weight(params, cfg)
    return x_last.float() @ w.float()


def prefill(params, batch: Dict[str, torch.Tensor], cfg, cache_len: int | None = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """batch {"tokens": [B,S] int on the device} -> (logits of the last
    position [B,V] float32, cache of capacity cache_len (default S),
    zero beyond S, pos = S); for the ssm family (logits, the states
    after the prompt), which needs S >= ssm_conv - 1."""
    require_ported(cfg)
    if cfg.family == "ssm":
        return _prefill_ssm(params, batch, cfg)
    cd = L.dtype_of(cfg.compute_dtype)
    x = F.embedding(batch["tokens"], params["embed"]).to(cd)
    B, S, _ = x.shape
    C = cache_len or S
    if C < S:
        raise ValueError(f"prefill: cache_len {C} is shorter than the prompt {S}")
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    ks = torch.zeros((cfg.n_layers, B, C, K, hd), dtype=cd, device=x.device)
    vs = torch.zeros_like(ks)
    rope = L.rope_tables(cfg, torch.arange(S, device=x.device), C)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y, (k, v) = L.gqa_attention(lp["attn"], h, cfg, rope, mask_mode="causal", return_kv=True)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
        x, h = L.residual_norm(lp["ln2"], x, y, cfg.norm)
        x = x + _apply_ffn(lp, h, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    pos = torch.full((), S, dtype=torch.int32, device=x.device)
    return _logits(params, x[:, -1], cfg), {"k": ks, "v": vs, "pos": pos}


def decode_step(params, token: torch.Tensor, cache: Dict[str, Any], cfg
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token [B,1] int on the device -> (logits [B,V] float32, cache with
    the step's k/v written at pos and pos + 1; for the ssm family, the
    cache with its states advanced by the token)."""
    require_ported(cfg)
    if cfg.family == "ssm":
        return _decode_ssm(params, token, cache, cfg)
    cd = L.dtype_of(cfg.compute_dtype)
    x = F.embedding(token, params["embed"]).to(cd)  # [B,1,D]
    pos = cache["pos"]
    rope = L.rope_tables(cfg, pos.reshape(1), cache["k"].shape[2])
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y = L.decode_attention(lp["attn"], h, cfg, rope, cache["k"][i], cache["v"][i], pos)
        x, h = L.residual_norm(lp["ln2"], x, y, cfg.norm)
        x = x + _apply_ffn(lp, h, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, x[:, -1], cfg), {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def _prefill_ssm(params, batch, cfg):
    cd = L.dtype_of(cfg.compute_dtype)
    x = F.embedding(batch["tokens"], params["embed"]).to(cd)
    B = x.shape[0]
    ssm = torch.empty((cfg.n_layers, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                      dtype=torch.float32, device=x.device)
    conv = torch.empty((cfg.n_layers, B, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                       dtype=cd, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y, (ssm[i], conv[i]) = mamba2.mamba_forward(lp["mamba"], h, cfg, return_state=True)
        x = x + y
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, x[:, -1], cfg), {"ssm": ssm, "conv": conv}


def _decode_ssm(params, token, cache, cfg):
    cd = L.dtype_of(cfg.compute_dtype)
    x = F.embedding(token, params["embed"]).to(cd)  # [B,1,D]
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        x = x + mamba2.mamba_decode_step(lp["mamba"], h, cfg, cache["ssm"][i], cache["conv"][i])
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, x[:, -1], cfg), {"ssm": cache["ssm"], "conv": cache["conv"]}
