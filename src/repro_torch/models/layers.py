"""Transformer building blocks (counterpart of `repro.models.layers`):
norms, rotary embeddings, GQA attention for prefill and for one decode
step, gated and plain MLPs. Plain functions on tensors; parameters are
dicts with the JAX package's names and layouts (wq [d,H,hd], wo
[H,hd,d], w_in [d,f], ...).

Attention goes through the port's kernels: prefill through
`ops.flash_attention` (where the JAX model runs its query-chunked
`attention_scores_chunked`), a decode step through `ops.flash_decode`
(where it runs `decode_attention`'s einsum softmax); the contracts are
the same (`tests/test_kernels.py` holds the Pallas kernels against those
two functions). Masked scores are -1e30 in the kernels against the
model's finfo(f32).min / 2: beside one valid key both weigh exactly 0.
The JAX `shard_hint` is a no-op on one device and has no counterpart.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.numerics import fma_f32, sincos_glibc, tanh_xla

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# --------------------------------------------------------------------------
# init helpers (torch generators: the numbers differ from jax.random's)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: float | None = None, dtype=torch.float32):
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return x.mul_(scale).to(dtype)  # in place: one float32 copy at the peak


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    return (torch.randn(tuple(shape), generator=gen, device=gen.device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_norm(d: int, kind: str, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """Normalises in float32 and returns x's dtype, or `out_dtype` (for
    a float32 x that stands for an unrounded low-precision sum, see
    `residual_norm`)."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # jnp.var: population
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(out_dtype or x.dtype)


def residual_norm(p, x: torch.Tensor, y: torch.Tensor, kind: str):
    """(x + y, apply_norm(x + y)) with the norm reading the sum before it
    is rounded to x's dtype, as XLA:CPU fuses the JAX block (it keeps
    the attention residual's add in float32 for the second norm and
    rounds it only for the stream). Exact no-op in float32."""
    s = x.float() + y.float()
    return s.to(x.dtype), apply_norm(p, s, kind, out_dtype=x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings (partial rotary, glm4 style)
# --------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions [S] -> (cos, sin), each [S, rot_dim/2] float32, bitwise
    as XLA:CPU computes them. The inverse frequencies are taken in
    float64 and rounded once, which is what XLA's constant folding of the
    JAX expression gives (a float32 pow differs by an ulp at some theta);
    the float32 angles go through glibc's cosf/sinf, which XLA:CPU calls
    (`numerics.sincos_glibc`: torch.cos and torch.sin differ from them by
    an ulp on about 5% of the angles)."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float64, device=positions.device) / rot_dim
    inv = (1.0 / (theta ** exps)).float()
    ang = positions.float()[..., None] * inv
    sin, cos = sincos_glibc(ang)
    return cos, sin


@functools.lru_cache(maxsize=16)
def _rope_table(rot_dim: int, theta: float, n: int, device: torch.device):
    return rope_angles(torch.arange(n, device=device), rot_dim, theta)


def rope_tables(cfg, positions: torch.Tensor, n: int):
    """(cos, sin) of `cfg`'s rotary dims at positions [S] (each < n), or
    None when the config does not rotate. The table of positions 0..n-1
    is computed once per (config, n, device) and kept, so a decode step
    only gathers its row: the same numbers as `rope_angles(positions)`
    for a few calls instead of several hundred. Computed once per
    prefill or decode step and handed to every layer."""
    if not (cfg.rope_fraction > 0 and cfg.n_heads):
        return None
    rot = int(cfg.resolved_head_dim * cfg.rope_fraction)
    cos, sin = _rope_table(rot, float(cfg.rope_theta), n, positions.device)
    return cos.index_select(0, positions), sin.index_select(0, positions)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, fraction: float):
    """x [B,S,H,hd]; cos/sin [S, rot/2]. Rotates the first int(hd *
    fraction) dims as two halves and passes the rest through; the
    products promote to float32 and the result is cast back once. Each
    half is one single-rounded FMA over a rounded product, as XLA:CPU
    contracts the JAX expression under `jit`."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    y1 = fma_f32(x1, cos, -(x2 * sin))  # x * sin: a float32 product (x promotes)
    y2 = fma_f32(x2, cos, x1 * sin)
    return torch.cat([y1, y2, xp.float()], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, dtype):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, H, hd), dtype=dtype),
        "wk": dense_init(gen, (d, K, hd), dtype=dtype),
        "wv": dense_init(gen, (d, K, hd), dtype=dtype),
        "wo": dense_init(gen, (H, hd, d), scale=1.0 / math.sqrt(H * hd * 2 * cfg.n_layers),
                         dtype=dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros((K, hd), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros((K, hd), dtype=dtype, device=gen.device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor, b, cd) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') (+ bias) in the compute dtype."""
    B, S, _ = x.shape
    d, n, hd = w.shape
    y = (x @ w.to(cd).reshape(d, n * hd)).reshape(B, S, n, hd)
    return y + b.to(cd) if b is not None else y


def _out_proj(y: torch.Tensor, wo: torch.Tensor, cd) -> torch.Tensor:
    """einsum('bshk,hkd->bsd')."""
    B, S, H, hd = y.shape
    return y.reshape(B, S, H * hd) @ wo.to(cd).reshape(H * hd, -1)


def qkv_rotated(p, x: torch.Tensor, cfg, rope):
    """q [B,S,H,hd], k, v [B,S,K,hd] of x [B,S,D], q and k rotated by
    `rope`, the (cos, sin) of `rope_tables` at x's positions (the keys as
    the cache stores them)."""
    cd = dtype_of(cfg.compute_dtype)
    q = _project(x, p["wq"], p.get("bq"), cd)
    k = _project(x, p["wk"], p.get("bk"), cd)
    v = _project(x, p["wv"], p.get("bv"), cd)
    if rope is not None:  # q and k rotated in one pass (fewer calls a layer)
        qk = apply_rope(torch.cat([q, k], dim=2), *rope, cfg.rope_fraction)
        q, k = qk[:, :, :q.shape[2]], qk[:, :, q.shape[2]:]
    return q, k, v


def gqa_attention(p, x: torch.Tensor, cfg, rope, *, mask_mode: str = "causal",
                  prefix_len: int = 0, return_kv: bool = False):
    """Self-attention over x [B,S,D] -> [B,S,D] (and, with return_kv,
    the rotated k and v [B,S,K,hd] for the cache); `rope` is
    `rope_tables(cfg, arange(S), n)`. The kernel reads the [B,S,H,hd]
    projections through strides, so the transposes to its [B,H,S,hd]
    layout and back copy nothing."""
    cd = dtype_of(cfg.compute_dtype)
    q, k, v = qkv_rotated(p, x, cfg, rope)
    y = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            mask_mode=mask_mode, prefix_len=prefix_len).transpose(1, 2)
    out = _out_proj(y, p["wo"], cd)
    return (out, (k, v)) if return_kv else out


def decode_attention(p, x: torch.Tensor, cfg, rope, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One decode step: x [B,1,D], `rope` = `rope_tables(cfg, pos[None], C)`,
    caches [B,C,K,hd], pos a 0-d int32 tensor on x's device. Writes the
    rotated k and v at `pos` into the caches IN PLACE (the JAX function
    returns updated copies), then attends over positions 0..pos. Returns
    [B,1,D]."""
    cd = dtype_of(cfg.compute_dtype)
    index = pos.reshape(1).long()
    q, k, v = qkv_rotated(p, x, cfg, rope)
    cache_k.index_copy_(1, index, k.to(cache_k.dtype))
    cache_v.index_copy_(1, index, v.to(cache_v.dtype))
    y = ops.flash_decode(q[:, 0], cache_k, cache_v, pos.reshape(1))  # [B,H,hd]
    return _out_proj(y[:, None].to(x.dtype), p["wo"], cd)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str, n_layers: int,
             dtype):
    p = {
        "w_in": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_out": dense_init(gen, (d_ff, d_model), scale=1.0 / math.sqrt(d_ff * 2 * n_layers),
                            dtype=dtype),
    }
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype=dtype)
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as XLA:CPU computes it: x * 1 / (1 + exp(-x)), each
    op rounded to x's dtype (F.silu rounds once; in bf16 the two differ
    by an ulp often enough to move a logit past 2e-2)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu (the tanh form) as XLA:CPU computes it under `jit`:
    0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))) * x, op by op in
    x's dtype with the constants rounded to it, and tanh as XLA's float32
    approximation (`numerics.tanh_xla`). In float32 the one multiply-add
    x + x^3 * c is contracted into an FMA; in bfloat16 every op rounds,
    so nothing is (both read from the compiled HLO and object code)."""
    def const(c):
        return torch.tensor(c, dtype=x.dtype).item()

    x3 = (x * x) * x
    if x.dtype == torch.float32:
        inner = fma_f32(x3, const(0.044715), x)
    else:
        inner = x + x3 * const(0.044715)
    t = inner * const(math.sqrt(2.0 / math.pi))
    th = tanh_xla(t.float()).to(x.dtype)
    return x * ((th + 1.0) * 0.5)


def apply_mlp(p, x: torch.Tensor, activation: str, compute_dtype) -> torch.Tensor:
    cd = dtype_of(compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    h = x @ p["w_in"].to(cd)
    if activation == "swiglu":
        h = silu(x @ p["w_gate"].to(cd)) * h
    elif activation == "geglu":
        h = gelu_tanh(x @ p["w_gate"].to(cd)) * h
    elif activation == "gelu":
        h = gelu_tanh(h)  # jax.nn.gelu's default
    elif activation == "relu":
        h = F.relu(h)
    else:
        raise ValueError(activation)
    return h @ p["w_out"].to(cd)
