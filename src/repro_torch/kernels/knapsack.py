"""The bounded-knapsack DP: plain PyTorch version and CUDA wrapper.

Counterpart of `repro.core.knapsack.bounded_knapsack_min` (a jnp scan,
not Pallas), batched over K knapsacks of M item types each: take x_m in
{0..cap_m} of type m, minimise sum score_m * x_m subject to sum
weight_m * x_m <= budget, on an energy grid of `grid` cells. The
reference runs one scan over the item types, each with
n_splits = ceil(log2(grid)) + 1 binary-split steps, every step over the
[grid + 1] best row and the [grid + 1, M] count table; `ExactDPPPolicy`
vmaps it over the clouds. Here all K knapsacks go into one call.

Rounding is the contract (read from the optimized LLVM IR of
`jit(bounded_knapsack_min)`, jax 0.9.0):

  budget' = max(budget, 1e-6)                   (NaN stays NaN)
  scale   = grid / budget'                      (a division)
  iw      = i32(max(ceil(fma(weight, scale, -1e-6)), 1))
  cap     = i32(score < 0 ? min(cap, floor(budget' / max(weight, 1e-9))) : 0)
  step s of type m: k = min(2**s, remaining), w = i32(f32(iw) * k),
    val = score * k (a multiply), cand = best[e - w] + val (an add),
    better = cand < best + (-1e-9), then best, cnt where better
  e* = argmin(best)                             (the first NaN, else the
                                                 first of equal values)

where i32 is XLA's saturating conversion (NaN to 0). The multiply-add of
`iw` is contracted into one FMA; `best[src] + val` is not (`val` is
computed once a step, outside the loop over the row).

`knapsack_dp_plain` runs that forward DP with the count table. The CUDA
kernel (`csrc/knapsack.cu`) runs a thread group a knapsack over the
active steps only (those with k > 0: a type whose cap > 0 takes
min(bit_length(cap), n_splits) of them), keeps one decision bit a step
and cell instead of the table, in records ordered by active step (bit
e & 31 of word e >> 5 for cell e), and walks back from e*; the table
only ever adds small integers along the path, so the walk gives the
table's counts bitwise.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.numerics import fma_f32

# Launches of the CUDA kernel in this process (read by chip_smoke.py).
launches = 0

_NEG_1E6 = float(np.float32(-1e-6))  # the reference's constants, as float32 values
_1E6 = float(np.float32(1e-6))
_1E9 = float(np.float32(1e-9))


def n_splits(grid: int) -> int:
    """The reference's split count: ceil(log2(grid)) + 1."""
    return int(np.ceil(np.log2(grid))) + 1


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: NaN to 0, out-of-range values
    saturated (an int64 tensor of int32 values)."""
    x = torch.where(torch.isnan(x), 0.0, x.double()).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return x.to(torch.int64)


def knapsack_items(scores, weights, caps, budget, grid: int):
    """Per-item integer weights and caps, as the reference rounds them:
    (iw [K, M], cap [K, M]) int64 tensors of int32 values."""
    budget = torch.clamp_min(budget.float(), _1E6)
    scale = torch.full_like(budget, float(grid)) / budget
    iw = to_i32(torch.clamp_min(torch.ceil(fma_f32(weights.float(), scale[:, None], _NEG_1E6)),
                                1.0))
    fits = torch.floor(budget[:, None] / torch.clamp_min(weights.float(), _1E9))
    cap = to_i32(torch.where(scores < 0, torch.minimum(caps.float(), fits), 0.0))
    return iw, cap


def _check(scores, weights, caps, budget, grid):
    if scores.dim() != 2 or weights.shape != scores.shape or caps.shape != scores.shape:
        raise ValueError(
            f"knapsack_dp: scores, weights and caps must be [K, M] alike, got "
            f"{tuple(scores.shape)}, {tuple(weights.shape)}, {tuple(caps.shape)}")
    if tuple(budget.shape) != tuple(scores.shape[:1]):
        raise ValueError(f"knapsack_dp: budget must be [K], got {tuple(budget.shape)}")
    if int(grid) < 1:
        raise ValueError(f"knapsack_dp: grid={grid!r} must be >= 1")


def first_argmin(best: torch.Tensor) -> torch.Tensor:
    """jnp.argmin along the last axis: the first NaN where there is one,
    else the first of equal least values (-0 and +0 equal)."""
    nan = torch.isnan(best)
    least = torch.argmin(torch.where(nan, math.inf, best), dim=-1)
    return torch.where(nan.any(-1), nan.to(torch.int32).argmax(-1), least)


def knapsack_dp_plain(scores, weights, caps, budget, grid: int) -> torch.Tensor:
    """K knapsacks -> counts [K, M] float32, JAX's forward DP with its
    count table. Steps whose k is 0 in every knapsack change nothing and
    are skipped (one host read of the caps a call)."""
    _check(scores, weights, caps, budget, grid)
    K, M = scores.shape
    dev = scores.device
    G = int(grid)
    scores = scores.float()
    iw, cap = knapsack_items(scores, weights, caps, budget, G)
    # step s of type m takes k > 0 exactly while s < bit_length(cap); the
    # plain version reads the caps on the host (the kernel skips on the card)
    active = [min(int(c).bit_length(), n_splits(G)) if c > 0 else 0
              for c in cap.amax(0).tolist()]  # lint: allow=host-cast
    best = torch.zeros(K, G + 1, dtype=torch.float32, device=dev)
    cnt = torch.zeros(K, G + 1, M, dtype=torch.float32, device=dev)
    e = torch.arange(G + 1, device=dev)
    neg_eps = torch.full((), -_1E9, dtype=torch.float32, device=dev)
    for m in range(M):
        remaining = cap[:, m]
        for s in range(active[m]):
            k = torch.minimum(torch.full_like(remaining, 2 ** s), remaining)
            kf = k.float()
            valid = k > 0
            w = to_i32(iw[:, m].float() * kf)
            val = scores[:, m] * kf
            src = torch.clamp(e[None, :] - w[:, None], 0, G)
            cand = torch.where((e[None, :] >= w[:, None]) & valid[:, None],
                               best.gather(1, src) + val[:, None], math.inf)
            better = cand < best + neg_eps
            best = torch.where(better, cand, best)
            src_cnt = cnt.gather(1, src[:, :, None].expand(K, G + 1, M)).clone()
            src_cnt[:, :, m] += kf[:, None]
            cnt = torch.where(better[:, :, None], src_cnt, cnt)
            remaining = remaining - k
    e_star = first_argmin(best)
    return cnt[torch.arange(K, device=dev), e_star]


def _lib():
    lib = build.load("knapsack")
    if lib.knapsack_dp_launch.argtypes is None:
        lib.knapsack_dp_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p] * 3
        lib.knapsack_dp_launch.restype = ctypes.c_int
        lib.knapsack_dp_instances.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int]
        lib.knapsack_dp_instances.restype = ctypes.c_int
        lib.knapsack_dp_scratch.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.knapsack_dp_scratch.restype = ctypes.c_int
    return lib


# The kernel's widest grid: the most cells for which a group's two best
# rows, its ring of record chunks, its step table and its staged types fit
# one block's shared memory (227 KB) for any M (ROADMAP Queue 3, limit L4;
# the reference takes any grid). Checked before the kernel is built; the
# library refuses a wider grid by its own layout.
MAX_GRID = 23455


def group_plan(K: int, grid: int, sms: int, instances) -> tuple:
    """(group, cells a thread) among the kernel's `instances` ((cells a
    thread, widest group), ...; `kernel_instances()` on the card): the
    least cells a thread, so the most threads, whose groups fit all K on
    the card at once (ceil(K / SMs) groups an SM within its warps; a warp
    a knapsack where K fills the card); past that, the fewest threads with
    the fewest cells a thread. Thread t holds cells t + j * group; any
    group size gives the same bits."""
    cells = grid + 1
    plans = [(threads, cpt) for cpt, most in instances
             for threads in (32 * -(-cells // (32 * cpt)),) if threads <= most]
    per_sm = -(-K // sms)
    for threads, cpt in plans:
        if per_sm * threads <= 1024:  # 64 registers a thread: 32 warps an SM
            return threads, cpt
    return min(plans)


def kernel_instances() -> tuple:
    """The library's instances: ((cells a thread, widest group), ...)."""
    lib = _lib()
    cells, most = (ctypes.c_int * 16)(), (ctypes.c_int * 16)()
    n = lib.knapsack_dp_instances(cells, most, 16)
    return tuple(zip(cells[:n], most[:n]))


def kernel_plan(K: int, M: int, grid: int, device) -> tuple:
    """A launch's (group, cells a thread, streamed record words a knapsack
    (0: the records stay in shared memory), staged types a knapsack past
    the 64 in shared memory), as `knapsack_dp_cuda` launches it."""
    group, cpt = group_plan(K, grid, torch.cuda.get_device_properties(device).multi_processor_count,
                            kernel_instances())
    out = (ctypes.c_longlong * 2)()
    if _lib().knapsack_dp_scratch(M, grid, group, out) != 0:
        raise ValueError(f"knapsack_dp: M={M} at grid {grid} does not fit shared memory")
    return group, cpt, int(out[0]), int(out[1])


def knapsack_dp_cuda(scores, weights, caps, budget, grid: int) -> torch.Tensor:
    """Launches csrc/knapsack.cu on PyTorch's current stream: a group of
    threads a knapsack (`kernel_plan`'s), all K in one launch. The records
    stay in shared memory where a group's share is at most 48 KB with
    them; else they pass through a ring of chunks to a global scratch, and
    back for the walk; M > 64 adds a [K, M - 64] int4 list of staged
    types. No host sync; capturable in a CUDA graph."""
    global launches
    _check(scores, weights, caps, budget, grid)
    K, M = scores.shape
    G = int(grid)
    dev = scores.device
    if K < 1 or M < 1:
        raise ValueError(f"knapsack_dp: empty problem K={K}, M={M}")
    if G > MAX_GRID:
        raise ValueError(f"knapsack_dp: grid={G} above the kernel's {MAX_GRID} cells "
                         "(limit L4: the reference takes any grid)")
    ins = []
    for name, x, shape in (("scores", scores, (K, M)), ("weights", weights, (K, M)),
                           ("caps", caps, (K, M)), ("budget", budget, (K,))):
        if x.dtype != torch.float32 or x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f"knapsack_dp: {name} must be float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        ins.append(x.contiguous())
    group, cpt, words, staged = kernel_plan(K, M, G, dev)
    out = torch.empty(K, M, dtype=torch.float32, device=dev)
    scratch = torch.empty(K * words, dtype=torch.int32, device=dev) if words else None
    glist = torch.empty(K * staged * 4, dtype=torch.int32, device=dev) if staged else None
    lib = _lib()
    status = lib.knapsack_dp_launch(
        *(x.data_ptr() for x in ins), out.data_ptr(), K, M, G, group, cpt,
        None if scratch is None else scratch.data_ptr(),
        None if glist is None else glist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "knapsack_dp")
    launches += 1
    return out
