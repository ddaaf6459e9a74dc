"""Serving entry points for the dense, moe, ssm, vlm and enc-dec
families (counterpart of `repro.models.serving`): prefill (build the
cache) and one-token decode. The moe family serves through the dense
path, its layers' FFN that of JAX's `_ffn_sub` (`transformer._apply_ffn`).
The vlm family's prefill puts the image's patch embeddings (the frontend
stub's output) before the text tokens and attends with the prefix-LM
mask (every position sees the whole image prefix); its decode step is the
dense one. The enc-dec family's prefill encodes a batch of frame
embeddings {"frames" [B,Ssrc,D]} (the speech frontend stub's output) and
projects every decoder layer's cross keys and values from it; no token
is consumed yet, so its logits are those of a zero hidden state, exactly
0 (JAX's convention: the first greedy token is 0). Its decode step adds
the sinusoidal table's row `pos` to the token's embedding, then per
layer self-attention over the self cache, cross-attention over the cross
cache and the FFN.

Caches:
  dense, moe, vlm: {"k" [L,B,C,K,hd], "v" [L,B,C,K,hd] in the compute dtype, "pos"
         a 0-d int32 tensor on the device}, C the cache capacity. The
         cache holds the rotated keys.
  ssm:   {"ssm" [L,B,H,N,P] float32, "conv" [L,B,W-1,C] in the compute
         dtype}: fixed size, no position (a prefill's cache_len is not
         read).
  enc-dec: {"k", "v" [L,B,C,K,hd] (the decoder's self-attention, zero
         after the prefill), "ck", "cv" [L,B,Ssrc,K,hd] (the cross keys and
         values), all in the compute dtype, "pos"}; C = cache_len or the
         config's source_len, as in the JAX package.
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
    embed_positions,
    encoder_forward,
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


def _patches(batch, cfg, tok_emb: torch.Tensor) -> torch.Tensor:
    """A vlm batch's "patches" [B, prefix_len, D], floating point, on the
    tokens' device (any float dtype: it is cast to the compute dtype, as
    the JAX package casts it)."""
    want = (tok_emb.shape[0], cfg.prefix_len, cfg.d_model)
    p = batch.get("patches")
    if p is None:
        raise ValueError(f"prefill: a {cfg.family} batch needs 'patches' {want} beside 'tokens'")
    if tuple(p.shape) != want or not p.dtype.is_floating_point or p.device != tok_emb.device:
        raise ValueError(f"prefill: patches must be floating point {want} on {tok_emb.device}, "
                         f"got {p.dtype} {tuple(p.shape)} on {p.device}")
    return p


def prefill(params, batch: Dict[str, torch.Tensor], cfg, cache_len: int | None = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """batch {"tokens": [B,S] int on the device} -> (logits of the last
    position [B,V] float32, cache of capacity cache_len (default S),
    zero beyond S, pos = S); for the ssm family (logits, the states
    after the prompt), which needs S >= ssm_conv - 1. A vlm batch also
    holds "patches" [B, prefix_len, D]: the sequence is the patches and
    then the text tokens, S = prefix_len + S_text, rotated over positions
    0..S-1 and attended under the prefix mask (prefix_len = cfg's); the
    cache holds all S positions. An enc-dec batch is {"frames"
    [B,Ssrc,D]} (see the module docstring)."""
    require_ported(cfg)
    if cfg.family == "ssm":
        return _prefill_ssm(params, batch, cfg)
    if cfg.is_encoder_decoder:
        return _prefill_encdec(params, batch, cfg, cache_len)
    cd = L.dtype_of(cfg.compute_dtype)
    x = F.embedding(batch["tokens"], params["embed"]).to(cd)
    mask_mode, prefix_len = "causal", 0
    if cfg.family == "vlm":
        x = torch.cat([_patches(batch, cfg, x).to(cd), x], dim=1)
        mask_mode, prefix_len = "prefix", cfg.prefix_len
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
        y, (k, v) = L.gqa_attention(lp["attn"], h, cfg, rope, mask_mode=mask_mode,
                                    prefix_len=prefix_len, return_kv=True)
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
    if cfg.is_encoder_decoder:
        return _decode_encdec(params, token, cache, cfg)
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


def _frames(batch, cfg, device) -> torch.Tensor:
    """An enc-dec batch's "frames" [B, Ssrc, d_model], floating point, on
    the parameters' device (any float dtype: it is cast to the compute
    dtype, as the JAX package casts it)."""
    f = batch.get("frames")
    if f is None:
        raise ValueError(f"prefill: an enc-dec batch needs 'frames' [B, source_len, "
                         f"{cfg.d_model}], got keys {sorted(batch)}")
    if (f.ndim != 3 or f.shape[0] < 1 or f.shape[1] < 1 or f.shape[2] != cfg.d_model
            or not f.dtype.is_floating_point or f.device != device):
        raise ValueError(f"prefill: frames must be floating point [B, source_len, {cfg.d_model}] "
                         f"on {device}, got {f.dtype} {tuple(f.shape)} on {f.device}")
    return f


def _prefill_encdec(params, batch, cfg, cache_len):
    cd = L.dtype_of(cfg.compute_dtype)
    dev = params["embed"].device
    enc = encoder_forward(params, _frames(batch, cfg, dev), cfg)
    B, Ssrc, _ = enc.shape
    C = cache_len or cfg.source_len
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cks = torch.empty((cfg.n_layers, B, Ssrc, K, hd), dtype=cd, device=dev)
    cvs = torch.empty_like(cks)
    for i in range(cfg.n_layers):
        cks[i], cvs[i] = L.cross_kv(layer(params["cross"], i)["attn"], enc, cfg)
    ks = torch.zeros((cfg.n_layers, B, C, K, hd), dtype=cd, device=dev)
    cache = {"k": ks, "v": torch.zeros_like(ks), "ck": cks, "cv": cvs,
             "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    # no token consumed yet: the logits of a zero hidden state (all 0)
    return _logits(params, torch.zeros((B, cfg.d_model), dtype=cd, device=dev), cfg), cache


def _decode_encdec(params, token, cache, cfg):
    cd = L.dtype_of(cfg.compute_dtype)
    pos = cache["pos"]
    table = L.sinusoidal_positions(cache["k"].shape[2], cfg.d_model, token.device)
    x = embed_positions(F.embedding(token, params["embed"]), table.index_select(0, pos.reshape(1)),
                        cd)  # [B,1,D]
    rope = L.rope_tables(cfg, pos.reshape(1), cache["k"].shape[2])
    for i in range(cfg.n_layers):
        lp, cp = layer(params["layers"], i), layer(params["cross"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y = L.decode_attention(lp["attn"], h, cfg, rope, cache["k"][i], cache["v"][i], pos)
        x, h = L.residual_norm(cp["ln"], x, y, cfg.norm)
        y = L.cross_attention(cp["attn"], h, cfg, cache["ck"][i], cache["cv"][i])
        x, h = L.residual_norm(lp["ln2"], x, y, cfg.norm)
        x = x + _apply_ffn(lp, h, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, x[:, -1], cfg), dict(cache, pos=pos + 1)
