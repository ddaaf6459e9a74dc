"""The greedy energy-budget fill: plain PyTorch version and CUDA wrapper.

Counterpart of `repro.core.policies.greedy_fill` (Algorithm 1, both
halves, batched over lanes). Per lane, the items whose score is negative
are visited in increasing (key, index) order, the key being `sort_key`
or score/e; at each item fits = floor(P/e), min(cap, fits) is taken and
the budget P is updated. The reference's chunked top_k/while_loop engine
gives exactly the counts of this full sequential walk (its exit test
only skips steps that change nothing), so `chunk` is accepted by the
callers and changes nothing here.

Rounding: under `jit` XLA:CPU contracts the budget update into one FMA
(`P - t*e` and, with the literal edge budget, `P - fits*e`), so both
versions round it once. The kernel lives in `csrc/greedy_fill.cu`; its
source note gives its bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.numerics import fma_f32

# Launches of the CUDA kernel in this process (read by chip_smoke.py).
launches = 0

MAX_ITEMS = 16384  # 12 bytes of shared memory per item (padded to 2^k)


def greedy_fill_plain(scores, unit_energy, max_items, budget, *,
                      stop_at_first_unfit=True, literal_edge_budget=False,
                      sort_key=None):
    """[B, M] inputs and [B] budget -> counts [B, M] float32.

    Vectorised over lanes: one stable sort of the masked keys (ties to
    the lower index, as lax.top_k resolves them), then one loop over
    sorted positions with [B]-wide tensor ops. Every few positions the
    loop reads on the host whether any lane can still change a count (it
    has not stopped and its budget covers the cheapest item left), and
    ends when none can, as the reference's while-loop exit test does."""
    stops = stop_at_first_unfit or literal_edge_budget
    key = sort_key if sort_key is not None else scores / unit_energy
    mkey = torch.where(scores < 0, key, torch.inf)
    skey, order = torch.sort(mkey, dim=-1, stable=True)
    valid = torch.isfinite(skey)  # finite key => score < 0, so no score test below
    e_s = torch.gather(unit_energy, -1, order)
    cap_s = torch.gather(max_items, -1, order)
    # cheapest energy at or after each sorted position, over walked items
    e_left = torch.where(valid, e_s, torch.inf).flip(-1).cummin(-1).values.flip(-1)
    e_T, cap_T, valid_T, e_left_T = (x.T.contiguous() for x in (e_s, cap_s, valid, e_left))
    B, M = scores.shape
    P = budget.to(torch.float32).clone()
    stopped = torch.zeros((B,), dtype=torch.bool, device=scores.device)
    takes = torch.zeros((M, B), dtype=scores.dtype, device=scores.device)
    for j in range(M):
        if j % 8 == 0 and not bool(((~stopped) & (P >= e_left_T[j])).any()):
            break
        e_j = e_T[j]
        fits = torch.floor(P / e_j)
        live = valid_T[j] & ~stopped
        can = live & (fits > 0.0)
        t_j = torch.where(can, torch.minimum(cap_T[j], fits), 0.0)
        if literal_edge_budget:
            P = torch.where(can, fma_f32(-fits, e_j, P), P)
        else:
            P = fma_f32(-t_j, e_j, P)
        if stops:
            stopped = stopped | (live & (fits <= 0.0))
        takes[j] = t_j
    return torch.zeros_like(scores).scatter_add_(-1, order, takes.T)


def _lib():
    lib = build.load("greedy_fill")
    if lib.greedy_fill_launch.argtypes is None:
        lib.greedy_fill_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        lib.greedy_fill_launch.restype = ctypes.c_int
    return lib


def _check_f32(name, x, shape, device):
    if x.dtype != torch.float32 or x.device != device or tuple(x.shape) != shape:
        raise ValueError(
            f"greedy_fill: {name} must be float32 {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )


def greedy_fill_cuda(scores, unit_energy, max_items, budget, *,
                     stop_at_first_unfit=True, literal_edge_budget=False,
                     sort_key=None):
    """Launches csrc/greedy_fill.cu (one block per lane) on PyTorch's
    current stream; counts start from a zeroed output."""
    global launches
    B, M = scores.shape
    if B < 1 or M < 1:
        raise ValueError(f"greedy_fill: empty problem B={B}, M={M}")
    if M > MAX_ITEMS:
        raise ValueError(f"greedy_fill kernel takes at most {MAX_ITEMS} items per lane, got {M}")
    dev = scores.device
    for name, x in (("scores", scores), ("unit_energy", unit_energy), ("max_items", max_items)):
        _check_f32(name, x, (B, M), dev)
    _check_f32("budget", budget, (B,), dev)
    if sort_key is not None:
        _check_f32("sort_key", sort_key, (B, M), dev)
        sort_key = sort_key.contiguous()
    scores, unit_energy, max_items, budget = (
        x.contiguous() for x in (scores, unit_energy, max_items, budget)
    )
    Mp = 1 << max(M - 1, 1).bit_length()
    threads = min(1024, max(32, Mp // 2))
    counts = torch.zeros((B, M), dtype=torch.float32, device=dev)
    lib = _lib()
    status = lib.greedy_fill_launch(
        scores.data_ptr(), unit_energy.data_ptr(), max_items.data_ptr(), budget.data_ptr(),
        sort_key.data_ptr() if sort_key is not None else None, counts.data_ptr(),
        B, M, Mp, threads, int(stop_at_first_unfit or literal_edge_budget),
        int(literal_edge_budget), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "greedy_fill")
    launches += 1
    return counts
