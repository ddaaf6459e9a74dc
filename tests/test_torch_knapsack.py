"""The knapsack DP and ExactDPPPolicy against the JAX package.

`knapsack_dp_plain` (the port's plain version of the `knapsack_dp`
kernel) is held to `jit(repro.core.knapsack.bounded_knapsack_min)`
bitwise, counts and all: random instances (M 1-16, grids 8-600, powers
of two and not), positives, caps past 2**n_splits - 1, items wider than
the grid, ties in the best row, weights near zero (XLA's saturating
int32 conversions), NaN and infinite budgets, and the crafted cases of
the reference's rounding points (the weight's cell count is one FMA
under jit; `best + score * k` is a multiply, then an add). The batched
form equals each knapsack run alone; the value equals the exact numpy
oracle where the grid is an integral budget; the CUDA kernel's design
is emulated: its prologue's active types and their steps against the
plain DP's own (k, w, val) sequence, its decision bits by active step for
every group size, and its walk back from e* against the count table.
ExactDPPPolicy's actions are JAX's under jit (the score pass
contracted, as `carbon_scores` rounds it), on the eight instances of
`tests/test_policies.py::test_greedy_vs_exact_dpp_gap` with its bounds,
and through `simulate`, the fleet, `simulate_vsweep`, the staleness
guard and `serve_loop`: queues and counts bitwise, emissions rtol 1e-6.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.faults as JF  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
from repro.configs import fleet_scenarios as jfs  # noqa: E402
from repro.configs import paper_workloads as jpw  # noqa: E402
from repro.core.knapsack import bounded_knapsack_min as j_knapsack  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.configs import paper_workloads as tpw  # noqa: E402
from repro_torch.core import dpp  # noqa: E402
from repro_torch.core.knapsack import (  # noqa: E402
    bounded_knapsack_min,
    bounded_knapsack_min_batch,
    exact_knapsack_min_py,
)
from repro_torch.core.queueing import is_feasible  # noqa: E402
from repro_torch.kernels import knapsack as KN  # noqa: E402
from repro_torch.serve import loop as tserve  # noqa: E402

f32 = np.float32
_JIT = jax.jit(j_knapsack, static_argnums=4)


def _jax_counts(sc, w, caps, bud, grid):
    """JAX's counts, one jitted call a knapsack -> [K, M]."""
    return np.stack([np.asarray(_JIT(jnp.asarray(sc[k]), jnp.asarray(w[k]), jnp.asarray(caps[k]),
                                     jnp.float32(bud[k]), grid)) for k in range(len(sc))])


def _plain(sc, w, caps, bud, grid):
    return KN.knapsack_dp_plain(*(torch.from_numpy(np.ascontiguousarray(x, f32))
                                  for x in (sc, w, caps, bud)), grid).numpy()


def _random(rng, K, M, grid):
    sc = (rng.standard_normal((K, M)) * rng.choice([1.0, 100.0])).astype(f32)
    w = rng.uniform(0.05, 30, (K, M)).astype(f32)
    caps = rng.integers(0, 3000, (K, M)).astype(f32)
    bud = rng.uniform(1, 500, K).astype(f32)
    return sc, w, caps, bud


@pytest.mark.parametrize("M,grid", [(1, 8), (3, 17), (5, 64), (7, 33), (8, 100), (2, 512),
                                    (12, 257), (16, 600)])
def test_plain_dp_is_jax_bitwise_on_random_instances(M, grid):
    """Tolerance: none (counts bitwise)."""
    rng = np.random.default_rng(M * 1000 + grid)
    args = _random(rng, 6, M, grid)
    np.testing.assert_array_equal(_plain(*args, grid), _jax_counts(*args, grid))


def test_plain_dp_edges_are_jax_bitwise():
    """Positives only, caps past 2**n_splits - 1 (grid 8: 15 copies at
    most), items wider than the grid, ties (equal items, equal values at
    several cells), weights of 0 and 1e-12 with caps past int32 (XLA
    saturates floor(budget / 1e-9)), NaN scores and caps, budgets of 0,
    -3, NaN and inf. Tolerance: none."""
    grid = 8
    cases = [
        ([3.0, 1.0, 0.5], [1.0, 2.0, 3.0], [5, 5, 5], 8.0),           # positives
        ([-1.0, -2.0, 0.0], [0.5, 1.0, 1.0], [5000, 40, 9], 8.0),     # caps past 15
        ([-5.0, -1.0, -2.0], [20.0, 9.0, 1.0], [3, 3, 3], 8.0),       # wider than the grid
        ([-1.0, -1.0, -1.0], [2.0, 2.0, 2.0], [2, 2, 2], 8.0),        # equal items
        ([-1.0, -2.0, -3.0], [1.0, 2.0, 3.0], [9, 9, 9], 8.0),        # equal value per cell
        ([-1.0, -1.0, -2.0], [0.0, 1e-12, 1.0], [1e10, 3e9, 2.0], 8.0),
        ([np.nan, -1.0, -2.0], [1.0, 1.0, 1.0], [3, np.nan, 2], 8.0),
        ([-1.0, -2.0, -3.0], [1.0, 1.0, 1.0], [3, 3, 3], 0.0),
        ([-1.0, -2.0, -3.0], [1.0, 1.0, 1.0], [3, 3, 3], -3.0),
        ([-1.0, -2.0, -3.0], [1.0, 1.0, 1.0], [3, 3, 3], np.nan),
        ([-1.0, -2.0, -3.0], [1.0, 1.0, 1.0], [3, 3, 3], np.inf),
    ]
    sc, w, caps, bud = (np.array(x, f32) for x in zip(*cases))
    np.testing.assert_array_equal(_plain(sc, w, caps, bud, grid), _jax_counts(sc, w, caps, bud,
                                                                              grid))


def test_cell_count_is_one_fma_under_jit():
    """ceil(weight * scale - 1e-6) is contracted under jit: at weight
    61.662136, budget 186.91333, grid 194 the product is 64 + 2**-18 +
    2.4e-7, so the fused form rounds to 64 (3 copies fit: 192 cells) and
    the unfused one to 64 + 2**-17 (65 a copy: 2 fit). jit gives 3,
    eager JAX 2; the port follows jit. Tolerance: none."""
    args = (np.array([[-1.0]], f32), np.array([[61.662136]], f32), np.array([[10.0]], f32),
            np.array([186.91333], f32))
    assert _plain(*args, 194).tolist() == [[3.0]]
    np.testing.assert_array_equal(_plain(*args, 194), _jax_counts(*args, 194))
    eager = j_knapsack(*(jnp.asarray(a[0]) for a in args[:3]), jnp.float32(186.91333), 194)
    assert np.asarray(eager).tolist() == [2.0]


def test_candidate_is_a_multiply_then_an_add():
    """`best[src] + scores[m] * k` is not fused: the second type's cap of
    6 splits into steps of 1, 2 and 3, the product 0.7 * 3 is inexact,
    and this instance's counts are [0, 5, 1] unfused (jit's) and
    [1, 6, 0] fused. Tolerance: none."""
    args = (np.array([[-0.2, -0.7, -0.9]], f32), np.array([[2.0, 1.0, 3.0]], f32),
            np.array([[4.0, 6.0, 7.0]], f32), np.array([8.0], f32))
    got = _plain(*args, 8)
    assert got.tolist() == [[0.0, 5.0, 1.0]]
    np.testing.assert_array_equal(got, _jax_counts(*args, 8))


def test_batch_equals_each_knapsack_alone():
    """One call over K knapsacks (its skipped steps those of the widest
    cap) gives each row's counts of the knapsack run alone."""
    rng = np.random.default_rng(7)
    sc, w, caps, bud = _random(rng, 9, 6, 40)
    caps[3] = 0.0
    caps[5] *= 40
    batch = _plain(sc, w, caps, bud, 40)
    for k in range(9):
        np.testing.assert_array_equal(batch[k], _plain(sc[k:k + 1], w[k:k + 1], caps[k:k + 1],
                                                       bud[k:k + 1], 40)[0])
        one = bounded_knapsack_min(torch.from_numpy(sc[k]), torch.from_numpy(w[k]),
                                   torch.from_numpy(caps[k]), float(bud[k]), 40)
        np.testing.assert_array_equal(one.numpy(), batch[k])


@pytest.mark.parametrize("seed", range(6))
def test_value_equals_exact_oracle_on_an_integral_grid(seed):
    """Integral weights and grid == budget: the DP's value is the exact
    optimum of `exact_knapsack_min_py` (float64); counts may differ on
    ties. Tolerance: rtol 1e-5 (float32 sums against float64)."""
    rng = np.random.default_rng(seed)
    M, budget = 5, 48
    sc = (-rng.uniform(0.1, 10, (1, M))).astype(f32)
    w = rng.integers(1, 9, (1, M)).astype(f32)
    caps = rng.integers(0, 12, (1, M)).astype(f32)
    got = _plain(sc, w, caps, np.array([budget], f32), budget)[0]
    counts, value = exact_knapsack_min_py(sc[0], w[0], caps[0], budget, resolution=budget)
    assert float(np.dot(got, w[0])) <= budget and np.all(got <= caps[0])
    np.testing.assert_allclose(float(np.dot(got.astype(np.float64), sc[0])), value, rtol=1e-5)
    assert exact_knapsack_min_py(sc[0], w[0], caps[0], 0.0)[1] == 0.0


def _active_types(iw, cap, sc, group):
    """The kernel's prologue for one knapsack: `group` threads each count
    the active types (cap > 0) of their block of ceil(M / group) types, a
    prefix sum over the threads orders them -> [(iw, cap, score, m)]."""
    M = len(cap)
    per = -(-M // group)
    blocks = [range(min(M, t * per), min(M, t * per + per)) for t in range(group)]
    counts = [sum(1 for m in blk if cap[m] > 0) for blk in blocks]
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = [None] * int(sum(counts))
    for t, blk in enumerate(blocks):
        p = int(first[t])
        for m in blk:
            if cap[m] > 0:
                out[p] = (int(iw[m]), int(cap[m]), f32(sc[m]), m)
                p += 1
    return out


def _split_k(cap, s):
    """The walk's closed form of step s's k: the copies left after steps
    0..s-1 of 1, 2, ..., 2**(s-1)."""
    return min(2 ** s, cap - 2 ** s + 1)


def _w(iw, k):
    return int(KN.to_i32(torch.tensor(f32(iw) * f32(k))))


def _active_steps(types, grid):
    """The table the kernel expands the active types into, in step order:
    [(m, k, w, val)]; a type takes min(bit_length(cap), n_splits) steps."""
    steps = []
    for iw, cap, score, m in types:
        for s in range(min(cap.bit_length(), KN.n_splits(grid))):
            k = _split_k(cap, s)
            steps.append((m, k, _w(iw, k), f32(score * f32(k))))
    return steps


def _plain_steps(sc, w, caps, bud, grid):
    """The plain DP's own (m, k, w, val) sequence, a knapsack a list: its
    steps with k > 0, by its formulas (`knapsack_dp_plain`'s loop)."""
    K, M = sc.shape
    scores = torch.from_numpy(sc)
    iw, cap = KN.knapsack_items(*(torch.from_numpy(x) for x in (sc, w, caps, bud)), grid)
    out = [[] for _ in range(K)]
    for m in range(M):
        remaining = cap[:, m]
        for s in range(KN.n_splits(grid)):
            k = torch.minimum(torch.full_like(remaining, 2 ** s), remaining)
            kf = k.float()
            wk = KN.to_i32(iw[:, m].float() * kf)
            val = scores[:, m] * kf
            for r in range(K):
                if int(k[r]) > 0:
                    out[r].append((m, int(k[r]), int(wk[r]), f32(val[r])))
            remaining = remaining - k
    return out


def _kernel_emulation(sc, w, caps, bud, grid, group):
    """The CUDA kernel's algorithm in numpy for a group of `group` threads:
    the prologue's active types, their steps, the forward DP on the best
    row alone with thread t holding cells t + j * group and one ballot word
    a warp and j (cell e: bit e & 31 of word e >> 5), one record of bit
    words an active step; then the walk back from e* = argmin(best), the
    last step first, recomputing each step's k and w from the active types
    walked backwards. -> (counts [K, M], [records of each knapsack])."""
    K, M = sc.shape
    iw, cap = (x.numpy() for x in KN.knapsack_items(*(torch.from_numpy(x) for x in
                                                      (sc, w, caps, bud)), grid))
    cells = grid + 1
    W = (cells + 31) // 32
    out = np.zeros((K, M), f32)
    records = []
    for r in range(K):
        types = _active_types(iw[r], cap[r], sc[r], group)
        best = np.zeros(cells, f32)
        recs = []
        for m, k, wk, val in _active_steps(types, grid):
            words = np.zeros(W, np.uint32)
            new = best.copy()
            for t in range(group):  # thread t, then its warp's ballot
                for e in range(t, cells, group):
                    if e >= wk:
                        cand = f32(best[e - wk] + val)
                        if cand < f32(best[e] + f32(-1e-9)):
                            new[e] = cand
                            words[e >> 5] |= np.uint32(1) << np.uint32(e & 31)
            best = new
            recs.append(words)
        records.append(recs)
        e = int(KN.first_argmin(torch.from_numpy(best)))
        i = len(recs) - 1
        for iw_q, cap_q, _, m in reversed(types):
            taken = 0
            for s in range(min(cap_q.bit_length(), KN.n_splits(grid)) - 1, -1, -1):
                k = _split_k(cap_q, s)
                if (int(recs[i][e >> 5]) >> (e & 31)) & 1:
                    taken += k
                    e -= _w(iw_q, k)
                i -= 1
            out[r, m] = taken
        assert i == -1
    return out, records


def _walk_back(sc, w, caps, bud, grid):
    return _kernel_emulation(sc, w, caps, bud, grid, group=96)[0]


@pytest.mark.parametrize("M,grid", [(4, 16), (9, 40), (3, 512)])
def test_kernel_walk_back_equals_the_count_table(M, grid):
    """Decision bits in records by active step and the walk back (its
    k and w recomputed from the active types) give the forward count
    table's counts bitwise (the kernel keeps no table)."""
    rng = np.random.default_rng(M + grid)
    args = _random(rng, 12, M, grid)
    args[0][:3] = np.round(args[0][:3])  # integral scores: ties in the best row
    np.testing.assert_array_equal(_walk_back(*args, grid), _plain(*args, grid))


def _step_cases():
    """Types with cap 0 between active ones, caps past 2**n_splits - 1,
    NaN and inf scores, weights, caps and budgets (grid 8: 4 splits)."""
    sc = np.array([[-1.0, -2.0, 3.0, -0.5, -4.0, -1.5],
                   [-1.0, np.nan, -2.0, -np.inf, -3.0, -1.0],
                   [-2.0, -1.0, -1.0, -3.0, -1.0, -0.25],
                   [-1.0, -2.0, -3.0, -1.0, -2.0, -3.0],
                   [-1.0, -2.0, -3.0, -1.0, -2.0, -3.0]], f32)
    w = np.array([[1.0, 0.5, 1.0, 2.0, 0.25, 1.0],
                  [1.0, 1.0, np.inf, 1.0, np.nan, 0.5],
                  [0.125, 0.5, 1.0, 1e-12, 2.0, 0.75],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], f32)
    caps = np.array([[5.0, 0.0, 7.0, 0.0, 40.0, 3.0],
                     [9.0, 3.0, 2.0, 8.0, 4.0, np.inf],
                     [1e6, 15.0, 16.0, 3e9, 0.0, 2.0],
                     [3.0, 3.0, 3.0, 3.0, 3.0, 3.0],
                     [3.0, 3.0, 3.0, 3.0, 3.0, 3.0]], f32)
    bud = np.array([8.0, 8.0, 8.0, np.inf, np.nan], f32)
    return sc, w, caps, bud


def test_active_steps_are_the_plain_dps_steps():
    """The prologue's active types, expanded into steps, are the plain
    DP's own (m, k, w, val) sequence bitwise, and the walk's closed-form k
    is the DP's min(2**s, remaining), for every group size's blocks of
    types; the NaN-budget knapsack and the inf-budget one included."""
    for grid in (8, 40):
        sc, w, caps, bud = _step_cases()
        want = _plain_steps(sc, w, caps, bud, grid)
        iw, cap = (x.numpy() for x in KN.knapsack_items(*(torch.from_numpy(x) for x in
                                                          (sc, w, caps, bud)), grid))
        assert any(c > 2 ** KN.n_splits(grid) - 1 for c in cap.ravel())  # caps past the splits
        for group in (32, 64, 96, 288, 544, 1024):
            for r in range(sc.shape[0]):
                got = _active_steps(_active_types(iw[r], cap[r], sc[r], group), grid)
                assert [(m, k, wk) for m, k, wk, _ in got] == [(m, k, wk) for m, k, wk, _ in
                                                               want[r]], (grid, group, r)
                np.testing.assert_array_equal(np.array([v for *_, v in got], f32),
                                              np.array([v for *_, v in want[r]], f32))


@pytest.mark.parametrize("grid", [16, 100, 512])
def test_every_group_size_gives_one_set_of_bits(grid):
    """The records of every group size are the same bits (cell e: bit
    e & 31 of word e >> 5), and each walks back to the count table's
    counts. Tolerance: none."""
    rng = np.random.default_rng(grid)
    args = _random(rng, 3, 5, grid)
    want = _plain(*args, grid)
    first = None
    for group in (32, 64, 96, 160, 288, 544, 1024):
        counts, records = _kernel_emulation(*args, grid, group)
        np.testing.assert_array_equal(counts, want)
        flat = [np.concatenate(r) if r else np.zeros(0, np.uint32) for r in records]
        if first is None:
            first = flat
        for a, b in zip(flat, first):
            np.testing.assert_array_equal(a, b)


# csrc/knapsack.cu's instances (kCells, most_threads): (cells a thread, widest group)
_INSTANCES = ((1, 1024), (2, 1024), (4, 1024), (8, 1024), (16, 1024), (17, 768), (32, 768))


def test_group_plan_covers_the_row_and_fits_the_card():
    """The host's (group, cells a thread): the most threads whose groups
    fit all K on a 132-SM card at once, a warp a knapsack where K fills it,
    and past that the warp with the fewest cells a thread."""
    plans = {K: KN.group_plan(K, 512, 132, _INSTANCES)
             for K in (1, 6, 257, 600, 1000, 2000, 3072, 5000)}
    assert plans == {1: (544, 1), 6: (544, 1), 257: (288, 2), 600: (160, 4), 1000: (96, 8),
                     2000: (64, 16), 3072: (32, 17), 5000: (32, 17)}
    assert KN.group_plan(100000, 1000, 132, _INSTANCES) == (32, 32)
    assert KN.group_plan(100000, 16, 132, _INSTANCES) == (32, 1)
    for grid in (1, 16, 512, 1023, 4097, KN.MAX_GRID):
        for K in (1, 257, 3072, 100000):
            group, cpt = KN.group_plan(K, grid, 132, _INSTANCES)
            assert group % 32 == 0 and group * cpt >= grid + 1
            assert cpt in dict(_INSTANCES) and group <= dict(_INSTANCES)[cpt]


def test_cuda_wrapper_checks_before_building():
    z = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="budget"):
        KN.knapsack_dp_cuda(z, z, z, torch.zeros(3), 8)
    with pytest.raises(ValueError, match="23455"):
        KN.knapsack_dp_cuda(z, z, z, torch.zeros(2), 23456)
    with pytest.raises(ValueError, match="float32"):
        KN.knapsack_dp_cuda(z.double(), z, z, torch.zeros(2), 8)
    assert KN.launches == 0
    assert KN.n_splits(512) == 10 and KN.n_splits(600) == 11 and KN.n_splits(1) == 1


# ------------------------------------------------------------ the policy


def _policy_instance(seed):
    """`tests/test_policies.py::test_greedy_vs_exact_dpp_gap`'s instance."""
    rng = np.random.default_rng(seed + 100)
    M, N, budget = 4, 3, 96
    fields = dict(pe=rng.integers(1, 8, M).astype(f32), pc=rng.integers(2, 20, (M, N)).astype(f32),
                  Pe=float(budget), Pc=np.full(N, float(budget), f32))
    Qe = rng.integers(0, 60, M).astype(f32)
    Qc = rng.integers(0, 60, (M, N)).astype(f32)
    Ce = f32(rng.uniform(0, 300))
    Cc = rng.uniform(0, 300, N).astype(f32)
    return fields, Qe, Qc, Ce, Cc, budget


def _jax_action(pol, fields, Qe, Qc, Ce, Cc):
    spec = J.NetworkSpec(**fields)
    return jax.jit(lambda s, ce, cc: pol(s, spec, ce, cc, None, None))(
        J.NetworkState(Qe=jnp.asarray(Qe), Qc=jnp.asarray(Qc)), jnp.float32(Ce), jnp.asarray(Cc))


def _port(fields, Qe, Qc, Ce, Cc):
    return (P.NetworkState(Qe=torch.from_numpy(Qe), Qc=torch.from_numpy(Qc)),
            P.NetworkSpec(**fields), torch.tensor(Ce), torch.from_numpy(Cc))


@pytest.mark.parametrize("seed", range(8))
def test_exact_dpp_actions_are_jax_and_beat_the_greedy(seed):
    """Actions bitwise JAX's under jit; the reference test's bounds hold
    in the port: feasible, at least as good as the greedy (1e-3), and the
    greedy within 15% of the optimum."""
    fields, Qe, Qc, Ce, Cc, budget = _policy_instance(seed)
    ref = _jax_action(J.ExactDPPPolicy(V=0.05, grid=budget), fields, Qe, Qc, Ce, Cc)
    state, spec, tCe, tCc = _port(fields, Qe, Qc, Ce, Cc)
    exact = P.ExactDPPPolicy(V=0.05, grid=budget)(state, spec, tCe, tCc)
    np.testing.assert_array_equal(exact.d.numpy(), np.asarray(ref.d))
    np.testing.assert_array_equal(exact.w.numpy(), np.asarray(ref.w))
    greedy = P.CarbonIntensityPolicy(V=0.05, stop_at_first_unfit=False)(state, spec, tCe, tCc)
    V = torch.tensor(f32(0.05))
    v_g = float(dpp.surrogate_value(state, spec, greedy, tCe, tCc, V))
    v_e = float(dpp.surrogate_value(state, spec, exact, tCe, tCc, V))
    assert bool(is_feasible(spec, exact))
    assert v_e <= v_g + 1e-3
    if v_e < -1e-6:
        assert v_g <= 0.85 * v_e


def test_exact_dpp_scores_are_contracted_under_jit():
    """The crafted instance where c = fma(V*Cc, pc, -Qc) and the unfused
    V*Cc*pc - Qc (`dpp.processing_scores`) give different cloud counts:
    jit takes the fused form, so the policy scores through
    `carbon_scores`. Tolerance: none."""
    fields = dict(pe=np.array([2.0, 3.0, 1.0], f32),
                  pc=np.array([[3.0, 3.0], [1.0, 2.0], [3.0, 1.0]], f32), Pe=16.0,
                  Pc=np.full(2, 16.0, f32))
    Qe = np.array([24.0, 28.0, 13.0], f32)
    Qc = np.array([[21.0, 0.0], [7.0, 23.0], [6.0, 3.0]], f32)
    Ce, Cc = f32(179.2675323486328), np.array([108.24205780029297, 132.54757690429688], f32)
    ref = _jax_action(J.ExactDPPPolicy(V=0.05, grid=16), fields, Qe, Qc, Ce, Cc)
    state, spec, tCe, tCc = _port(fields, Qe, Qc, Ce, Cc)
    got = P.ExactDPPPolicy(V=0.05, grid=16)(state, spec, tCe, tCc)
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(ref.w))
    np.testing.assert_array_equal(got.d.numpy(), np.asarray(ref.d))
    pe, pc, _, Pc = spec.as_arrays("cpu")
    c = dpp.processing_scores(state, pc, tCc, torch.tensor(f32(0.05)))
    w0 = bounded_knapsack_min(c[:, 0], pc[:, 0], state.Qc[:, 0], Pc[0], 16)
    assert not torch.equal(w0, got.w[:, 0])  # the unfused scores take another count


SCALARS = ("emissions", "cum_emissions", "energy_edge", "energy_cloud")


def _assert_run(got, ref, ints=("Qe", "Qc", "dispatched", "processed")):
    for name in ints:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in SCALARS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-3, err_msg=name)


def test_exact_dpp_simulate_matches_jax_and_serve():
    """The paper setup at grid 512 (Fig. 2's streams), T = 24: queues and
    counts bitwise, emissions rtol 1e-6; serve_loop equals the run."""
    T = 24
    ref = jax.jit(lambda k: J.simulate(J.ExactDPPPolicy(V=0.05), jpw.paper_spec(),
                                       J.RandomCarbonSource(N=5), J.UniformArrivals(M=5), T, k))(
        jax.random.PRNGKey(0))
    args = (P.ExactDPPPolicy(V=0.05), tpw.paper_spec(), P.RandomCarbonSource(N=5),
            P.UniformArrivals(M=5), T, 0)
    got = P.simulate(*args, device="cpu")
    _assert_run(got, ref)
    assert float(got.processed.sum()) > 0
    rep = tserve.serve_loop(*args, device="cpu")
    np.testing.assert_array_equal(rep.emissions, got.emissions.numpy())
    assert torch.equal(rep.state.Qe, got.Qe[-1]) and torch.equal(rep.state.Qc, got.Qc[-1])


def test_exact_dpp_fleet_matches_jax_and_lanes_alone():
    """Three registry kinds, two lanes each, grid 32 (the audit's): JAX's
    vmapped fleet under jit, and each lane equal to its instance alone."""
    T = 16
    jf = jfs.build_fleet(("diurnal", "bursty", "overload"), per_kind=2, M=5, N=5, Tc=24, seed=0)
    ref = jax.jit(lambda k: J.simulate_fleet(J.ExactDPPPolicy(grid=32), jf, T, k))(
        jax.random.PRNGKey(0))
    fleet = convert.fleet_from_reference(jf)
    pol = P.ExactDPPPolicy(grid=32)
    got = P.simulate_fleet(pol, fleet, T, 0, device="cpu")
    _assert_run(got, ref)
    keys = R.split(R.PRNGKey(0, device="cpu"), fleet.F)
    for f in (0, 3, 5):
        spec = P.NetworkSpec(*(x[f] for x in fleet.spec))
        one = P.simulate(pol, spec, P.TableCarbonSource(table=fleet.carbon[f]),
                         P.FleetArrivals(amax=fleet.arrival_amax[f]), T, keys[f], device="cpu")
        for name in ("Qe", "Qc", "emissions", "dispatched", "processed"):
            assert torch.equal(getattr(got, name)[f], getattr(one, name)), (f, name)


def test_exact_dpp_vsweep_matches_jax():
    """V an [F] tensor: JAX's vmap over V under jit."""
    Vs, T = (0.01, 0.05, 0.2), 12
    ref = jax.jit(lambda k: J.simulate_vsweep(
        lambda V: J.ExactDPPPolicy(V=V, grid=64), jnp.asarray(Vs, jnp.float32), jpw.paper_spec(),
        J.RandomCarbonSource(N=5), J.UniformArrivals(M=5), T, k))(jax.random.PRNGKey(1))
    got = P.simulate_vsweep(lambda V: P.ExactDPPPolicy(V=V, grid=64), Vs, tpw.paper_spec(),
                            P.RandomCarbonSource(N=5), P.UniformArrivals(M=5), T, 1, device="cpu")
    _assert_run(got, ref)


def test_exact_dpp_under_the_staleness_guard_matches_jax():
    """ExactDPPPolicy as the guard's inner policy through a faulted run
    (brownouts and telemetry dropouts: the decayed V is a tensor)."""
    kw = dict(cloud_p_down=0.1, cloud_p_up=0.3, telem_p_down=0.3, telem_p_up=0.3,
              brown_p_start=0.2, brown_p_end=0.3, brown_floor=0.5)
    T = 16
    table = np.asarray(J.carbon.diurnal_table(48, 5, np.random.default_rng(3)))
    ref = jax.jit(lambda fp, k: J.simulate(
        JF.StalenessGuardPolicy(J.ExactDPPPolicy(grid=64), stale_after=6), jfs._base(5, 5),
        J.TableCarbonSource(table=table), J.UniformArrivals(M=5, amax=300), T, k, faults=fp))(
        JF.make_faults(5, **kw), jax.random.PRNGKey(1))
    got = P.simulate(PF.StalenessGuardPolicy(P.ExactDPPPolicy(grid=64), stale_after=6),
                     tfs._base(5, 5), P.TableCarbonSource(table=table),
                     P.UniformArrivals(M=5, amax=300), T, 1, device="cpu",
                     faults=PF.make_faults(5, device="cpu", **kw))
    _assert_run(got, ref, ints=("Qe", "Qc", "dispatched", "processed", "stale", "retry"))
    assert int(got.stale.max()) > 0 and not math.isnan(float(got.emissions.sum()))


def test_batched_helper_takes_host_values():
    counts = bounded_knapsack_min_batch([[-1.0, -2.0]], [[1.0, 1.0]], [[3.0, 3.0]], [4.0], 4,
                                        device="cpu")
    assert counts.dtype == torch.float32 and counts.tolist() == [[1.0, 3.0]]


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_constants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # defines constants and functions; main() does not run
    return mod


def test_exact_jax_reduction_pinned():
    """EXACT_JAX, which chip_smoke.py phase 4i holds the card's run to:
    ExactDPPPolicy(V=0.05, grid 512) against QueueLength on the Fig. 2
    setup, `jit(simulate)` at PRNGKey(0), T=2000, jax 0.9.0 on the CPU."""
    cs_mod = _chip_smoke()
    key = jax.random.PRNGKey(0)

    def cum(pol):
        return float(jax.jit(lambda: J.simulate(
            pol, jpw.paper_spec(), J.RandomCarbonSource(N=5), J.UniformArrivals(M=5, amax=400),
            2000, key).cum_emissions[-1])())

    got = 100.0 * (1.0 - cum(J.ExactDPPPolicy(V=0.05, grid=cs_mod.KP_GRID))
                   / cum(J.QueueLengthPolicy()))
    assert got == cs_mod.EXACT_JAX


def test_chip_smoke_crafted_knapsacks_are_jaxs():
    """KP_CRAFTED and KP_EDGES, which phase 3f holds the kernel to on the
    card: the crafted counts are jit(bounded_knapsack_min)'s and the
    plain version's, the edges the CPU test's cases."""
    cs_mod = _chip_smoke()
    for label, (args, grid, want) in cs_mod.KP_CRAFTED.items():
        a = tuple(np.array(x, f32) for x in args)
        assert _jax_counts(*a, grid).tolist() == want == _plain(*a, grid).tolist(), label
    edges = np.array(cs_mod.KP_EDGES, f32)
    for grid in (16, 1024):
        args = (edges[:, 0], edges[:, 1], edges[:, 2], edges[:, 3, 0])
        np.testing.assert_array_equal(_plain(*args, grid), _jax_counts(*args, grid))
