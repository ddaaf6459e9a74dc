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
versions round it once.

The kernel (`csrc/greedy_fill.cu`, whose source note has the proofs and
bounds) sorts each lane's live items in one block, then classifies every step
by two thresholds fixed before the walk: with k = max(1, ceil(cap)), T is
the least float32 with floor(P/e) >= k for every P >= T (the step takes
cap by one FMA), U the same for k = 1 (below it the step takes nothing).
Only a step with U <= P < T, where the budget binds, divides. A lane
whose budget provably never binds (a float64 prefix-sum certificate with
a margin for the float32 chain's rounding) writes its caps without
walking; warp 0 walks the others. `fill_thresholds`,
`fill_certified` and `fill_walk_profile` are that design in plain
PyTorch: the tests hold it against `greedy_fill_plain` and the JAX
engine, and `chip_smoke.py` reads the walk lengths from it. The plain
version stays the straightforward walk, the kernel's reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.numerics import fma_f32

# Launches of the CUDA kernel in this process (read by chip_smoke.py).
launches = 0

MAX_ITEMS = 16384  # 12 bytes of shared memory per item (padded to 2^k)
MAX_THREADS = 512  # the kernel's launch bounds (2 blocks an SM)
SEARCH_STEPS = 4  # ulp steps a threshold search may take (the kernel's kSearchSteps)
CAP_LIMIT = float(2 ** 24)  # caps at or above it get NaN thresholds
_FLT_MIN, _FLT_MAX = torch.finfo(torch.float32).tiny, torch.finfo(torch.float32).max
_CERT_E = 2.0 ** -24 * (1 + 2.0 ** -20)  # the certificate's float32-chain margin per step, / P0
_CERT_K = 1 + 2.0 ** -30  # ... and its cover for the float64 roundings
_CERT_MIN_P0 = 2.0 ** -100


def threads_for(Mp: int) -> int:
    """The kernel's block size for a lane padded to Mp items."""
    return min(MAX_THREADS, max(32, Mp // 2))


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


def _ulp_step(x, d: int):
    """x > 0 finite float32: the float32 d ulps away (d = -1 or +1)."""
    return (x.view(torch.int32) + d).view(torch.float32)


def _least_reaching(e, k):
    """Elementwise least float32 x with x / e >= k (correctly rounded), or
    NaN where the search from RN(k*e) does not settle within SEARCH_STEPS
    ulps; e positive, finite and normal, k an integer >= 1. The kernel's
    `least_reaching`, step for step."""
    x = k * e
    ok = x <= _FLT_MAX
    hit = (x / e) >= k
    out = torch.full_like(e, float("nan"))
    down, up = ok & hit, ok & ~hit  # step down while the ulp below passes / up until one passes
    xd, xu = x, x
    for _ in range(SEARCH_STEPS):
        below = _ulp_step(xd, -1)
        fails = ~((below / e) >= k)
        out = torch.where(down & fails, xd, out)
        down = down & ~fails
        xd = torch.where(down, below, xd)
        xu = torch.where(up, _ulp_step(xu, 1), xu)
        over = ~(xu <= _FLT_MAX)
        reach = (xu / e) >= k
        out = torch.where(up & ~over & reach, xu, out)
        up = up & ~over & ~reach
    return out


def fill_thresholds(unit_energy, max_items):
    """Elementwise (T, U), float32, of the kernel's threshold pass: T is
    the least float32 with floor(T / e) >= max(1, ceil(cap)) (so a step
    with P >= T takes cap), U the same for cap 1 (a step with P < U takes
    nothing). Both are NaN where the kernel takes the exact step instead:
    e not positive, finite and normal; cap NaN, infinite or >= 2^24; a
    search that does not settle."""
    e, cap = unit_energy, max_items
    valid = (e >= _FLT_MIN) & (e <= _FLT_MAX) & (cap >= -_FLT_MAX) & (cap < CAP_LIMIT)
    k = torch.clamp(torch.ceil(cap), min=1.0)
    U = _least_reaching(e, torch.ones_like(e))
    T = torch.where(k == 1.0, U, _least_reaching(e, k))
    bad = ~valid | U.isnan() | T.isnan()
    nan = torch.full_like(e, float("nan"))
    return torch.where(bad, nan, T), torch.where(bad, nan, U)


def fill_certified(unit_energy, max_items, T, live, budget):
    """The kernel's certificate: [B, L] energies, caps and T in walk order
    (`live` marks each row's walked prefix) and a [B] budget -> [B] bool,
    true where every step of the lane provably takes its cap (proof:
    csrc/greedy_fill.cu, note (4)). The float64 prefix sums run in
    another order than the kernel's, so the two may differ within a few
    float64 ulps of the margin; either answer gives the same counts."""
    t = torch.where(live, max_items.double() * unit_energy.double(), 0.0)
    S = torch.cumsum(t, -1)
    S = torch.cat([torch.zeros_like(S[:, :1]), S[:, :-1]], -1)  # exclusive, additions only
    P0 = budget.double()[:, None]
    j = torch.arange(t.shape[-1], dtype=torch.float64, device=t.device)
    need = ((S + T.double()) + j * (P0 * _CERT_E)) * _CERT_K
    cap = max_items
    item_ok = (~T.isnan() & (cap >= 0) & (cap < CAP_LIMIT) & (cap == torch.floor(cap))
               & (need <= P0))
    lane_ok = (budget >= _CERT_MIN_P0) & (budget <= _FLT_MAX)
    return lane_ok & (item_ok | ~live).all(-1)


def fill_walk_profile(scores, unit_energy, max_items, budget, *,
                      stop_at_first_unfit=True, literal_edge_budget=False,
                      sort_key=None):
    """The kernel's design in plain PyTorch. [B, M] inputs and a [B]
    budget -> (counts [B, M], certified [B] bool, steps [B], exact [B]):
    the counts (bitwise those of `greedy_fill_plain`), the lanes with
    items that the certificate spares a walk, and for every other lane
    the steps its walker takes (skipped chunks not counted) and how many
    of them divide (the exact step). A walk ends where the kernel's does: at a stop,
    where P falls below the least U from the current thread chunk on
    (no-stop variants), or where P is NaN; a no-stop walk in class B at
    a chunk's end skips the chunks whose every U is above P."""
    stops = stop_at_first_unfit or literal_edge_budget
    B, M = scores.shape
    dev = scores.device
    key = sort_key if sort_key is not None else scores / unit_energy
    mkey = torch.where((scores < 0) & torch.isfinite(key), key, torch.inf)
    skey, order = torch.sort(mkey, dim=-1, stable=True)
    live = torch.isfinite(skey)
    e_s = torch.gather(unit_energy, -1, order)
    cap_s = torch.gather(max_items, -1, order)
    T, U = fill_thresholds(e_s, cap_s)
    if literal_edge_budget:
        T = torch.full_like(T, float("nan"))
    n = live.sum(-1)
    certified = fill_certified(e_s, cap_s, T, live, budget) & (n > 0)
    # thread chunks of R positions: each one's least U (NaN U as -inf), and
    # the least from each chunk on
    nt = threads_for(1 << max(M - 1, 1).bit_length())
    R = ((n + nt - 1) // nt).clamp(min=1)
    nchunks = (n + R - 1) // R
    chunk_of = (torch.arange(M, device=dev)[None, :] // R[:, None]).clamp(max=M - 1)
    Uq = torch.where(live, torch.where(U.isnan(), -torch.inf, U), torch.inf)
    chunk_min = torch.full_like(Uq, torch.inf).scatter_reduce_(-1, chunk_of, Uq, "amin")
    tail_min = chunk_min.flip(-1).cummin(-1).values.flip(-1)
    chunk_ids = torch.arange(M, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    P = budget.to(torch.float32).clone()
    j = torch.zeros(B, dtype=torch.int64, device=dev)
    done = certified | (n == 0)
    steps = torch.zeros(B, dtype=torch.int64, device=dev)
    exact = torch.zeros(B, dtype=torch.int64, device=dev)
    takes = torch.zeros_like(scores)
    for it in range(M + 1):
        done = done | (j >= n)
        if it % 8 == 0 and bool(done.all()):
            break
        act = ~done
        jj = j.clamp(max=M - 1)[:, None]
        T_j, U_j, e_j, c_j = (x.gather(-1, jj)[:, 0] for x in (T, U, e_s, cap_s))
        jc, jr = jj[:, 0] // R, jj[:, 0] % R
        a = act & (P >= T_j)  # takes cap
        b = act & ~a & (P < U_j)  # takes nothing
        x = act & ~a & ~b  # the exact step
        fits = torch.floor(P / e_j)
        can = x & (fits > 0.0)
        take = torch.where(a, c_j, torch.where(can, torch.minimum(c_j, fits), 0.0))
        if literal_edge_budget:
            P_next = torch.where(can, fma_f32(-fits, e_j, P), P)
        else:
            P_next = torch.where(a | x, fma_f32(-take, e_j, P), P)
        if stops:
            ends = b | (x & (fits <= 0.0))
            j_next = j + 1
        else:
            ends = b & (P < tail_min.gather(-1, jc[:, None])[:, 0])
            skip = b & ~ends & (jr == R - 1)
            ahead = ((chunk_ids > jc[:, None]) & (chunk_ids < nchunks[:, None])
                     & ~(P[:, None] < chunk_min))
            first = torch.where(ahead.any(-1), ahead.int().argmax(-1), nchunks)
            j_next = torch.where(skip, torch.minimum(first * R, n), j + 1)
        ends = ends | (x & P_next.isnan())
        takes[rows[act], j[act]] = take[act]
        P = torch.where(act, P_next, P)
        steps += act
        exact += x
        done = done | ends
        j = torch.where(act, j_next, j)
    takes = torch.where(certified[:, None] & live, cap_s, takes)
    counts = torch.zeros_like(scores).scatter_add_(-1, order, takes)
    return counts, certified, steps, exact


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
    """Launches csrc/greedy_fill.cu (one block of `threads_for(Mp)`
    threads per lane) on PyTorch's current stream; the kernel writes
    every count."""
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
    threads = threads_for(Mp)
    counts = torch.empty((B, M), dtype=torch.float32, device=dev)  # the kernel writes every count
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
