"""Dense, MoE, SSM, VLM and enc-dec stacks, and the dense and ssm
families' training loss (counterpart of the dense, moe, ssm, vlm and enc-dec parts
of `repro.models.transformer`).

Parameters are nested dicts with the JAX package's names, and the layer
stack keeps its leading layer axis ([L, ...] per leaf), so
`convert.params_from_reference` maps a JAX pytree onto them leaf for
leaf. Where the JAX package scans over the layer axis, the port loops
over it in Python. A MoE layer's FFN is `moe.apply_moe` plus the
always-on shared MLP and Arctic's parallel dense residual MLP
(`_apply_ffn`). A VLM's stack is the dense one (PaliGemma: MQA, GeGLU,
tied embeddings, so no `unembed` leaf); its image prefix enters in
`serving.prefill`. An enc-dec model (SeamlessM4T) holds three stacks:
"encoder" (dense layers under the full mask, `encoder_forward`), the
decoder's "layers" and "cross" ({"ln", "attn"} a decoder layer: the
cross-attention over the encoder's output, `decoder_forward_encdec`).

Training (`lm_loss`, the dense and ssm families): `backbone` runs each layer under
`torch.utils.checkpoint` when autograd records and `cfg.remat` is
"block", as the JAX package's `jax.checkpoint` saves only each block's
input; `chunked_ce_loss` recomputes each chunk's float32 logits in the
backward, as its `@jax.checkpoint` chunk does (`_ChunkCE`), so no
[B, chunk, V] logits outlive their chunk; an ssm layer's SSD step is
differentiated by its own backward kernel (`ops.ssd_chunk_intra`). The
other families' losses, hybrid stacks,
and MoE on every other layer (`moe_every` 2, which only the hybrid Jamba
uses) are later slices (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe


def require_ported(cfg) -> None:
    """Admits the families the port serves, dense, moe (MoE on every
    layer), ssm, vlm and enc-dec (`is_encoder_decoder`, the "audio"
    family); raises NotImplementedError for the rest."""
    if cfg.n_experts and cfg.moe_every > 1 and cfg.family in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: MoE every {cfg.moe_every} layers is not ported to repro_torch yet; the "
            "JAX package stacks such layers in pairs, which only the hybrid family uses "
            "(ROADMAP Queue 1, item 3.3 hybrid)")
    ported = cfg.family in ("dense", "moe", "ssm", "vlm") or (
        cfg.is_encoder_decoder and cfg.family == "audio")
    if not ported:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to repro_torch yet "
            "(ROADMAP Queue 1, item 3.3 hybrid); the port serves the dense, moe, ssm, "
            "vlm and enc-dec families")


# the families the port serves but cannot train yet -> the ROADMAP item
_NOT_TRAINABLE = {
    "moe": "moe training (ROADMAP Queue 1, item 3.7)",
    "vlm": "vlm training, which needs the attention backward at hd 256 (ROADMAP Queue 1, "
           "item 3.8)",
    "audio": "enc-dec training (ROADMAP Queue 1, item 3.9)",
}


def require_trainable(cfg) -> None:
    """Admits the families the port trains, dense and ssm (`lm_loss`);
    raises NotImplementedError naming the ROADMAP item of any other."""
    require_ported(cfg)
    family = "moe" if cfg.n_experts else cfg.family
    if family not in ("dense", "ssm") or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family's training loss is not ported to repro_torch "
            f"yet: {_NOT_TRAINABLE['audio' if cfg.is_encoder_decoder else family]}; the port "
            "trains the dense and ssm families")


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
    if cfg.is_encoder_decoder:
        enc_cfg = dataclasses.replace(cfg, n_experts=0)
        p["encoder"] = _stack(lambda: _init_dense_layer(gen, enc_cfg, dtype),
                              cfg.n_encoder_layers)
        p["cross"] = _stack(lambda: {"ln": L.init_norm(cfg.d_model, cfg.norm, dtype, gen.device),
                                     "attn": L.init_attention(gen, cfg, dtype)}, cfg.n_layers)
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
    """Runs the decoder stack on embedded inputs x [B,S,D]. While autograd
    records, with cfg.remat "block", each layer runs under
    `torch.utils.checkpoint` (non-reentrant): only its input is kept, and
    its forward runs again in the backward, as the JAX package's
    `jax.checkpoint` with `save_only_these_names("block_in")` does."""
    require_ported(cfg)
    S = x.shape[1]
    rope = None if cfg.family == "ssm" else L.rope_tables(cfg, torch.arange(S, device=x.device), S)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        if cfg.family == "ssm":
            args, block = (x, lp, cfg), _ssm_block
        else:
            args, block = (x, lp, cfg, rope, mask_mode, prefix_len), _dense_block
        x = checkpoint(block, *args, use_reentrant=False) if remat else block(*args)
    return L.apply_norm(params["final_norm"], x, cfg.norm)


def embed_positions(emb: torch.Tensor, table: torch.Tensor, cd) -> torch.Tensor:
    """emb + table, both rounded to the compute dtype and added in it,
    as the JAX package's `x + table.astype(cd)` does (emb [B,S,D] in any
    float dtype, table [S,D] float32)."""
    return emb.to(cd) + table.to(cd)


def encoder_forward(params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """The enc-dec encoder over frame embeddings [B,Ssrc,D] (the
    frontend stub's output) -> [B,Ssrc,D] in the compute dtype: the
    frames plus the sinusoidal table, then the "encoder" stack of dense
    blocks, rotated at positions 0..Ssrc-1, under the full mask. As in
    the JAX package, no final norm."""
    cd = L.dtype_of(cfg.compute_dtype)
    S = frames.shape[1]
    x = embed_positions(frames, L.sinusoidal_positions(S, cfg.d_model, frames.device), cd)
    rope = L.rope_tables(cfg, torch.arange(S, device=x.device), S)
    for i in range(cfg.n_encoder_layers):
        x = _dense_block(x, layer(params["encoder"], i), cfg, rope, "full", 0)
    return x


def decoder_forward_encdec(params, tokens: torch.Tensor, enc_out: torch.Tensor, cfg
                           ) -> torch.Tensor:
    """The enc-dec decoder, teacher-forced over tokens [B,S] against the
    encoder's output enc_out [B,Ssrc,D] -> the final-normed hidden state
    [B,S,D] (no logits, as the JAX function returns none): the embedding
    plus the sinusoidal table, then per layer causal self-attention
    (rotated), the cross-attention over ck / cv projected from enc_out,
    and the FFN, each a pre-norm residual (the two norms after a residual
    add read its float32 sum, as XLA:CPU fuses them: `residual_norm`);
    `final_norm` at the end."""
    cd = L.dtype_of(cfg.compute_dtype)
    S = tokens.shape[1]
    x = embed_positions(F.embedding(tokens, params["embed"]),
                        L.sinusoidal_positions(S, cfg.d_model, tokens.device), cd)
    rope = L.rope_tables(cfg, torch.arange(S, device=x.device), S)
    for i in range(cfg.n_layers):
        lp, cp = layer(params["layers"], i), layer(params["cross"], i)
        h = L.apply_norm(lp["ln1"], x, cfg.norm)
        y = L.gqa_attention(lp["attn"], h, cfg, rope, mask_mode="causal")
        x, h = L.residual_norm(cp["ln"], x, y, cfg.norm)
        y = L.cross_attention(cp["attn"], h, cfg, *L.cross_kv(cp["attn"], enc_out, cfg))
        x, h = L.residual_norm(lp["ln2"], x, y, cfg.norm)
        x = x + _apply_ffn(lp, h, cfg)
    return L.apply_norm(params["final_norm"], x, cfg.norm)


def _unembed_weight(params, cfg) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]  # [D, V]


# --------------------------------------------------------------------------
# losses (sequence-chunked unembed + CE)
# --------------------------------------------------------------------------

class _ChunkCE(torch.autograd.Function):
    """One chunk's (sum of token losses, count of valid labels): float32
    logits xb [B,c,D] @ w [D,V], logsumexp minus the label's logit, labels
    -1 ignored. The backward recomputes the logits from xb and w, as the
    JAX chunk's `@jax.checkpoint` does, and turns them in place into the
    gradient (softmax - onehot) * g: one [B,c,V] float32 tensor alive, where
    autograd through the recompute would hold four (at Qwen1.5-0.5B's
    training shape each is 9.96 GB)."""

    @staticmethod
    def forward(ctx, xb, lb, w):
        logits = xb.float() @ w
        idx = lb.clamp_min(0).long()[..., None]
        ll = torch.gather(logits, -1, idx)[..., 0]
        m = logits.amax(dim=-1, keepdim=True)
        lse = torch.log(logits.sub_(m).exp_().sum(dim=-1)) + m[..., 0]
        valid = (lb >= 0).float()
        ctx.save_for_backward(xb, idx, w, lse, valid)
        return torch.sum((lse - ll) * valid), torch.sum(valid)

    @staticmethod
    def backward(ctx, g_loss, g_count):
        del g_count  # the count is an integer's float
        xb, idx, w, lse, valid = ctx.saved_tensors
        xf = xb.float()
        dlogits = (xf @ w).sub_(lse[..., None]).exp_()  # softmax
        dlogits.scatter_(-1, idx, torch.gather(dlogits, -1, idx) - 1.0)  # one label a row
        dlogits.mul_((valid * g_loss)[..., None])
        dx = (dlogits @ w.T).to(xb.dtype)
        dw = xf.reshape(-1, xf.shape[-1]).T @ dlogits.reshape(-1, dlogits.shape[-1])
        return dx, None, dw


def chunked_ce_loss(params, x: torch.Tensor, labels: torch.Tensor, cfg
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,S,D], labels [B,S] int (-1 = ignore) -> (mean loss over the
    valid labels, {"loss", "tokens"}), as `repro.models.transformer.
    chunked_ce_loss`: the unembed and cross-entropy in float32 over
    sequence chunks of cfg.logit_chunk positions (`_ChunkCE`), never the
    whole [B,S,V] logits, and no chunk's logits kept for the backward. A
    ragged last chunk is cut short where JAX pads it with ignored labels,
    which add exact zeros."""
    S = x.shape[1]
    w = _unembed_weight(params, cfg).float()  # [D, V], one float32 copy for every chunk
    chunk = min(cfg.logit_chunk, S)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        part, count = _ChunkCE.apply(x[:, s0:s0 + chunk], labels[:, s0:s0 + chunk], w)
        loss_sum = loss_sum + part
        n = n + count
    loss = loss_sum / torch.clamp_min(n, 1.0)
    return loss, {"loss": loss, "tokens": n}


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The causal LM training loss of a dense or ssm model on batch
    {"tokens", "labels"} [B,S] (`repro.models.transformer.lm_loss`, its
    decoder-only branch): the embedding in the compute dtype, the backbone
    (under the causal mask: an ssm stack is causal by construction),
    `chunked_ce_loss`. The other families raise NotImplementedError
    (`require_trainable`)."""
    require_trainable(cfg)
    cd = L.dtype_of(cfg.compute_dtype)
    x = F.embedding(batch["tokens"].long(), params["embed"].to(cd))
    x = backbone(params, x, cfg, mask_mode="causal")
    return chunked_ce_loss(params, x, batch["labels"], cfg)
