"""Serving entry points for the dense family (counterpart of
`repro.models.serving`): prefill (build the KV cache) and one-token
decode.

Cache: {"k" [L,B,C,K,hd], "v" [L,B,C,K,hd] in the compute dtype, "pos"
a 0-d int32 tensor on the device}, C the cache capacity. The cache holds
the rotated keys. `decode_step` writes into "k" and "v" IN PLACE (the
JAX function returns new arrays) and returns a new "pos"; nothing in a
step reads device data on the host. Every other family raises
NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.transformer import (
    _apply_ffn,
    _unembed_weight,
    layer,
    require_dense,
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
    zero beyond S, pos = S)."""
    require_dense(cfg)
    cd = L.dtype_of(cfg.compute_dtype)
    x = F.embedding(batch["tokens"], params["embed"]).to(cd)
    B, S, _ = x.shape
    C = cache_len or S
    if C < S:
        raise ValueError(f"prefill: cache_len {C} is shorter than the prompt {S}")
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    ks = torch.zeros((cfg.n_layers, B, C, K, hd), dtype=cd, device=x.device)
    vs = torch.zeros_like(ks)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y, (k, v) = L.gqa_attention(lp["attn"], h, cfg, mask_mode="causal", return_kv=True)
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
    the step's k/v written at pos and pos + 1)."""
    require_dense(cfg)
    cd = L.dtype_of(cfg.compute_dtype)
    x = F.embedding(token, params["embed"]).to(cd)  # [B,1,D]
    pos = cache["pos"]
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y = L.decode_attention(lp["attn"], h, cfg, cache["k"][i], cache["v"][i], pos)
        x, h = L.residual_norm(lp["ln2"], x, y, cfg.norm)
        x = x + _apply_ffn(lp, h, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, x[:, -1], cfg), {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
