"""Device dispatch for the port's kernels (counterpart of
`repro.kernels.ops`).

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, and a failed build or launch raises.
There is no fallback from the card to the plain version.
`flash_attention` and `ssd_chunk_intra` are differentiable: autograd
Functions whose forward and backward are each picked this way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import carbon_score as _cs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import greedy_fill as _gf
from repro_torch.kernels import knapsack as _kp
from repro_torch.kernels import route_score as _rs
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import taps as _taps
from repro_torch.kernels import threefry as _tf

def _pick(x, plain, cuda, what):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"{what}: no kernel for device {x.device}")


def carbon_scores(Qc, pc, Qe, pe, VCc, V_Ce):
    """Fused score pass -> (c [M,N], n1 [M] int32, b [M]). The inputs
    are pre-scaled, as the JAX kernel contract takes them: VCc = V*Cc
    and V_Ce = V*Ce (a 0-d tensor)."""
    fn = _pick(Qc, _cs.carbon_scores_plain, _cs.carbon_scores_cuda, "carbon_scores")
    return fn(Qc, pc, Qe, pe, VCc, V_Ce)


def route_scores(Qt, pt, Qcr, extra, Qe, pe, VCt, V_Ce):
    """WAN route-score pass -> (rc [M,L], l1 [M] int32, b [M]). Inputs
    as the JAX kernel contract takes them (Qcr = Qc[:, dest], VCt =
    V*Ct, V_Ce = V*Ce a 0-d tensor); `extra` may be None, which selects
    the rounding of the policy's default route_compute_weight 0."""
    fn = _pick(Qt, _rs.route_scores_plain, _rs.route_scores_cuda, "route_scores")
    return fn(Qt, pt, Qcr, extra, Qe, pe, VCt, V_Ce)


def greedy_fill(scores, unit_energy, max_items, budget, *,
                stop_at_first_unfit=True, literal_edge_budget=False,
                sort_key=None):
    """Batched fill on [B, M] inputs and a [B] budget -> counts [B, M]."""
    fn = _pick(scores, _gf.greedy_fill_plain, _gf.greedy_fill_cuda, "greedy_fill")
    return fn(scores, unit_energy, max_items, budget,
              stop_at_first_unfit=stop_at_first_unfit,
              literal_edge_budget=literal_edge_budget, sort_key=sort_key)


def knapsack_dp(scores, weights, caps, budget, grid):
    """K bounded knapsacks (minimisation) on an energy grid of `grid`
    cells: [K, M] scores, weights and caps and a [K] budget -> counts
    [K, M] float32 (`repro.core.knapsack.bounded_knapsack_min` a row)."""
    fn = _pick(scores, _kp.knapsack_dp_plain, _kp.knapsack_dp_cuda, "knapsack_dp")
    return fn(scores, weights, caps, budget, grid)


class _FlashAttention(torch.autograd.Function):
    """Forward: `flash_attention_plain` / `flash_attention_cuda`; backward:
    `flash_attention_bwd_plain` / `flash_attention_bwd_cuda`, both by
    `_pick`. q, k, v are saved only when one of them needs a gradient, so
    a call without autograd (serving) saves nothing and asks for nothing.
    Under autograd the bf16 kernel also writes what the bf16 backward
    kernel reads, each row's log-sum-exp and the float32 output (`stats`),
    and those are saved too (hd 16-128: the backward has no hd 256
    instance)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_mode, prefix_len):
        fn = _pick(q, _fa.flash_attention_plain, _fa.flash_attention_cuda, "flash_attention")
        grad = any(ctx.needs_input_grad[:3])
        ctx.mask_mode, ctx.prefix_len = mask_mode, prefix_len
        if (grad and fn is _fa.flash_attention_cuda and q.dtype == torch.bfloat16
                and q.shape[-1] in _fa.BWD_HEAD_DIMS):
            out, lse, o32 = fn(q, k, v, mask_mode=mask_mode, prefix_len=prefix_len, stats=True)
            ctx.save_for_backward(q, k, v, lse, o32)
            return out
        if grad:
            ctx.save_for_backward(q, k, v)
        return fn(q, k, v, mask_mode=mask_mode, prefix_len=prefix_len)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, *stats = ctx.saved_tensors
        fn = _pick(q, _fa.flash_attention_bwd_plain, _fa.flash_attention_bwd_cuda,
                   "flash_attention_bwd")
        kw = dict(zip(("lse", "o32"), stats))
        dq, dk, dv = fn(q, k, v, dout, mask_mode=ctx.mask_mode, prefix_len=ctx.prefix_len, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, mask_mode="causal", prefix_len=0):
    """GQA attention: q [B,H,Sq,hd], k/v [B,K,Skv,hd] -> [B,H,Sq,hd];
    mask_mode causal | prefix | full. Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, mask_mode, prefix_len)


def flash_decode(q, k, v, pos):
    """One query per (sequence, head) over a KV cache: q [B,H,hd], k/v
    [B,S,K,hd], cache positions 0..pos valid -> [B,H,hd]."""
    fn = _pick(q, _fd.flash_decode_plain, _fd.flash_decode_cuda, "flash_decode")
    return fn(q, k, v, pos)


class _SSDChunkIntra(torch.autograd.Function):
    """Forward `fwd`, backward `bwd` (the (a, x, Bm, Cm) -> (y_diag, S_c,
    total) step and its (dy, dS, dtot) -> (da, dx, dB, dC)). a, x, Bm and
    Cm are saved only when one of them needs a gradient, so a call
    without autograd (serving) saves nothing and launches no backward."""

    @staticmethod
    def forward(ctx, a, x, Bm, Cm, fwd, bwd):
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(a, x, Bm, Cm)
            ctx.bwd = bwd
        return fwd(a, x, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dS, dtot):
        a, x, Bm, Cm = ctx.saved_tensors
        grads = ctx.bwd(a, x, Bm, Cm, dy.contiguous(), dS.contiguous(), dtot.contiguous())
        return (*grads, None, None)


def ssd_chunk_intra(a, x, Bm, Cm):
    """Mamba-2 SSD intra-chunk step: a [B,nc,l,H], x [B,nc,l,H,P],
    Bm/Cm [B,nc,l,N] -> (y_diag [B,nc,l,H,P], S_c [B,nc,H,N,P], total
    [B,nc,H]), float32. Differentiable in a, x, Bm and Cm."""
    fwd = _pick(a, _ssd.ssd_chunk_intra_plain, _ssd.ssd_chunk_intra_cuda, "ssd_chunk_intra")
    bwd = _pick(a, _ssd.ssd_chunk_intra_bwd_plain, _ssd.ssd_chunk_intra_bwd_cuda,
                "ssd_chunk_intra_bwd")
    return _SSDChunkIntra.apply(a, x, Bm, Cm, fwd, bwd)


def ssd_chunk_intra_with(fwd, bwd):
    """`ssd_chunk_intra` through the given forward and backward on any
    device, for comparisons: e.g. the plain versions on the card, what a
    kernels-vs-plain check of a training step swaps in (autograd through
    the plain forward's einsums would form exp(ci_i - ci_j) above the
    diagonal, which overflows at the init's decays, and multiply its
    cotangent 0 by inf)."""
    return lambda a, x, Bm, Cm: _SSDChunkIntra.apply(a, x, Bm, Cm, fwd, bwd)


def threefry_draw(keys, t, n, *, finish="uniform", seg=None, fold_each=False, chain=None,
                  minval=0, maxval=1, scale=None, paths=None, count=None):
    """One threefry draw of n values per key: keys [..., 2] (int64
    holding uint32 pairs), folded with the slot t when it is given ->
    [..., n]; with `count`, the slots t..t+count-1 in one draw ->
    [count, ..., n] (see `kernels/threefry.py` for the walks seg,
    fold_each, chain and paths and the finishes)."""
    fn = _pick(keys, _tf.threefry_draw_plain, _tf.threefry_draw_cuda, "threefry_draw")
    return fn(keys, t, n, finish=finish, seg=seg, fold_each=fold_each, chain=chain,
              minval=minval, maxval=maxval, scale=scale, paths=paths, count=count)


def tap_scan(cfg, probe, out, state, t0, t1):
    """The telemetry taps over slots t0..t1-1 of a run: `probe` a
    TelemetryProbe of [*lanes, T] series, `out` a `taps.TapOut`, `state`
    the packed [*lanes, 7] TapState (both written in place); at t1 = T
    also the run's gauges and alert records (see `kernels/taps.py`)."""
    fn = _pick(probe.backlog, _taps.tap_scan_plain, _taps.tap_scan_cuda, "tap_scan")
    fn(cfg, probe, out, state, t0, t1)


def tap_probe(plan, t, inputs):
    """Slot t of a run's probe sums (`taps.ProbePlan`: which inputs, into
    which [*lanes, T] series, and the backlog's parts), every sum in
    XLA:CPU's order, one launch on the card."""
    fn = _pick(plan, _taps.tap_probe_plain, _taps.tap_probe_cuda, "tap_probe")
    fn(plan, t, inputs)


# kernel name -> (module, its launch counter)
_COUNTERS = {"carbon_scores": (_cs, "launches"), "route_scores": (_rs, "launches"),
             "greedy_fill": (_gf, "launches"), "flash_attention": (_fa, "launches"),
             "flash_attention_bwd": (_fa, "bwd_launches"),
             "flash_decode": (_fd, "launches"), "ssd_chunk_intra": (_ssd, "launches"),
             "ssd_chunk_intra_bwd": (_ssd, "bwd_launches"),
             "threefry_draw": (_tf, "launches"), "tap_scan": (_taps, "launches"),
             "tap_probe": (_taps, "probe_launches"), "knapsack_dp": (_kp, "launches")}


def launch_counts() -> dict:
    """{kernel name: launches of its CUDA kernel so far}."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def path_launches() -> int:
    """Launches of `threefry_draw` with `paths=` so far (each is also one
    of `launch_counts()["threefry_draw"]`)."""
    return _tf.path_launches


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
    _tf.path_launches = 0
