"""Mamba-2 layer (counterpart of `repro.models.mamba2`): the SSD
(state-space duality) chunked algorithm [arXiv:2405.21060].

Recurrence per head (state h in R^{d_state x head_dim}):
    h_t = exp(a_t) h_{t-1} + dt_t B_t (x) x_t        a_t = dt_t A
    y_t = C_t^T h_t + D x_t
computed chunk-parallel: the intra-chunk quadratic term and each chunk's
state contribution by the `ssd_chunk_intra` kernel (`kernels/ssd_chunk.py`,
the Pallas kernel's counterpart; the JAX model computes the same terms
with jnp einsums, and `tests/test_kernels.py` holds the two equal), then
a loop over chunks carries the state, and the state at each chunk start
gives the off-diagonal output term (a PyTorch product, as the JAX package
leaves it to XLA). Training differentiates the step with its backward
kernel (`ops.ssd_chunk_intra` is an autograd Function) and the rest by
autograd, as the JAX package differentiates its einsums.

Parameters are dicts with the JAX package's names and layouts. Casts
mirror the JAX function: projections in the compute dtype, the conv
summed in float32 and rounded, `silu` and `softplus` in float32 (there
`F.silu`, one pass, differs from XLA's by float32 ulps only; the dense
layers' op-by-op `layers.silu` matters for bf16 rounding).
Padding, chunk counts and the chunk loop use Python ints only: nothing
here reads device data on the host.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.numerics import cumsum_xla
from repro_torch.models import layers as L


def init_ssm_layer(gen: torch.Generator, cfg, dtype):
    """One layer's parameters on the generator's device (torch's
    normals, not jax.random's): in_proj -> [z (di) | xBC (di + 2ds) | dt
    (nh)], the depthwise conv, A_log = log U(1, 16), D = 1, dt_bias = 0
    (A_log, D and dt_bias float32), the gate norm and out_proj."""
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * ds
    dev = gen.device
    return {
        "in_proj": L.dense_init(gen, (d, 2 * di + 2 * ds + nh), dtype=dtype),
        "conv_w": L.dense_init(gen, (cfg.ssm_conv, conv_ch), scale=1.0 / math.sqrt(cfg.ssm_conv),
                               dtype=dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.rand((nh,), generator=gen, device=dev) * 15.0 + 1.0),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "gate_norm": L.init_norm(di, "rmsnorm", dtype, dev),
        "out_proj": L.dense_init(gen, (di, d), scale=1.0 / math.sqrt(di * 2 * cfg.n_layers),
                                 dtype=dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, which is logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)); F.softplus switches to x above 20 and otherwise
    takes log1p(exp(x)), which rounds differently."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H] (post-softplus), A [H] (negative), Bm/Cm
    [B,S,N], h0 [B,H,N,P] or None -> (y [B,S,H,P] float32, final state
    [B,H,N,P] float32). Pads with dt = 0 (decay 1, no update) to a
    multiple of chunk = min(chunk, S)."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // chunk

    a = (dt * A[None, None, :]).float()  # [B,S,H] log-decays
    xd = (x * dt[..., None]).float()     # dt-weighted input
    ac = a.reshape(B_, nc, chunk, H)
    xc = xd.reshape(B_, nc, chunk, H, P)
    Bc = Bm.float().reshape(B_, nc, chunk, N).contiguous()
    Cc = Cm.float().reshape(B_, nc, chunk, N).contiguous()

    # intra-chunk terms and chunk states (the kernel)
    y_diag, S_c, total = ops.ssd_chunk_intra(ac, xc, Bc, Cc)

    # inter-chunk recurrence: the state at each chunk's start (stacked, not
    # written into a buffer, so that autograd carries the gradient to h0,
    # total and S_c)
    h = torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * total[:, c, :, None, None] + S_c[:, c]
    h_starts = torch.stack(starts, dim=1)

    # off-diagonal output: C_l . h_start, decayed from the chunk start
    decay_from_start = torch.exp(cumsum_xla(ac, dim=2))  # [B,nc,l,H]
    y_off = torch.einsum("bcln,bchnp->bclhp", Cc, h_starts) * decay_from_start[..., None]
    y = (y_diag + y_off).reshape(B_, nc * chunk, H, P)[:, :S]
    return y, h


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, x [B,S,C], w [W,C]: the JAX function's
    tap-by-tap float32 sum, rounded to x's dtype once."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i].float()
    return (out + b.float()).to(x.dtype)


def _split(zxbcdt: torch.Tensor, cfg):
    di, ds = cfg.d_inner, cfg.ssm_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * ds], zxbcdt[..., 2 * di + 2 * ds:]


def _gate_out(p, y: torch.Tensor, z: torch.Tensor, cd) -> torch.Tensor:
    """y * silu(z) in float32, the gate norm in the compute dtype, out_proj."""
    y = y * F.silu(z.float())
    y = L.apply_norm(p["gate_norm"], y.to(cd), "rmsnorm")
    return y @ p["out_proj"].to(cd)


def mamba_forward(p, x: torch.Tensor, cfg, h0=None, conv0=None, return_state: bool = False):
    """Full-sequence Mamba-2 mixer, x [B,S,D] -> [B,S,D]. With
    return_state, also (ssm state [B,H,N,P] float32, conv state
    [B,W-1,C]), the conv state being the last W-1 rows of this call's
    conv input as the JAX function takes them; that needs S >= W-1
    (a shorter prompt raises ValueError: the JAX function would return a
    conv state of the wrong length)."""
    B, S, _ = x.shape
    cd = L.dtype_of(cfg.compute_dtype)
    di, ds, nh, hd, W = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
    if return_state and S < W - 1:
        raise ValueError(f"mamba_forward: a prompt of {S} tokens is shorter than the conv "
                         f"state (ssm_conv - 1 = {W - 1}); prefill needs at least {W - 1}")
    z, xBC, dt_raw = _split(x @ p["in_proj"].to(cd), cfg)
    if conv0 is not None:
        xBC_in = torch.cat([conv0.to(xBC.dtype), xBC], dim=1)
        xBC_conv = _causal_conv(xBC_in, p["conv_w"], p["conv_b"])[:, conv0.shape[1]:]
    else:
        xBC_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xBC_conv = F.silu(xBC_conv.float()).to(cd)

    xs = xBC_conv[..., :di].reshape(B, S, nh, hd)
    Bm = xBC_conv[..., di:di + ds]
    Cm = xBC_conv[..., di + ds:]
    dt = softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])

    y, hT = ssd_chunked(xs.float(), dt, A, Bm, Cm, cfg.ssm_chunk, h0=h0)
    y = y + xs.float() * p["D"][None, None, :, None]
    out = _gate_out(p, y.reshape(B, S, di), z, cd)
    if return_state:
        return out, (hT, xBC[:, S - (W - 1):, :])
    return out


def mamba_decode_step(p, x: torch.Tensor, cfg, ssm_state: torch.Tensor,
                      conv_state: torch.Tensor) -> torch.Tensor:
    """One-token decode, x [B,1,D] -> [B,1,D]. Updates ssm_state
    [B,H,N,P] (float32) and conv_state [B,W-1,C] IN PLACE (the JAX
    function returns new states)."""
    B = x.shape[0]
    cd = L.dtype_of(cfg.compute_dtype)
    di, ds, nh, hd, W = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
    z, xBC, dt_raw = _split(x @ p["in_proj"].to(cd), cfg)

    conv_in = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)  # [B,W,C]
    xBC_conv = (torch.einsum("bwc,wc->bc", conv_in[:, -W:].float(), p["conv_w"].float())
                + p["conv_b"].float())[:, None, :]
    xBC_conv = F.silu(xBC_conv).to(cd)
    conv_state.copy_(conv_in[:, 1:])

    xs = xBC_conv[..., :di].reshape(B, nh, hd)
    Bm = xBC_conv[:, 0, di:di + ds].float()
    Cm = xBC_conv[:, 0, di + ds:].float()
    dt = softplus(dt_raw[:, 0, :].float() + p["dt_bias"][None, :])  # [B,H]
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])
    xd = xs.float() * dt[..., None]  # [B,H,P]
    ssm_state.mul_(decay[..., None, None]).add_(Bm[:, None, :, None] * xd[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", Cm, ssm_state)
    y = y + xs.float() * p["D"][None, :, None]
    return _gate_out(p, y.reshape(B, 1, di), z, cd)
