"""The arithmetic of the greedy fill kernel's classified walk, on the CPU.

The CUDA kernel (`csrc/greedy_fill.cu`) classifies each step of the walk
by two thresholds fixed before it (T: the step takes cap; U: below it the
step takes nothing), divides only where the budget binds, and spares the
walk to a lane whose budget provably never binds (a float64 certificate).
`fill_thresholds`, `fill_certified` and `fill_walk_profile` are that design
in plain PyTorch. Here the thresholds are checked against their definition
with numpy's float32 division, and the design's counts against
`greedy_fill_plain` and the JAX engine, bitwise, in every variant; the
kernel itself is held against `greedy_fill_plain` on the card by
chip_smoke.py.
"""
from fractions import Fraction

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import greedy_fill as jax_fill  # noqa: E402
from repro_torch.kernels import greedy_fill as gf  # noqa: E402

f32 = np.float32
FLT_MAX = np.finfo(f32).max

VARIANTS = {
    "stop": dict(stop_at_first_unfit=True),
    "nostop": dict(stop_at_first_unfit=False),
    "literal": dict(literal_edge_budget=True),
    "sort_key": dict(stop_at_first_unfit=False),
}


def _kwargs(variant, scores, framework):
    kw = dict(VARIANTS[variant])
    if variant == "sort_key":
        kw["sort_key"] = jnp.asarray(scores) if framework == "jax" else torch.from_numpy(scores)
    return kw


def _sort_key_scores(caps):
    """QueueLengthPolicy's ordering: the longest queue first."""
    return np.where(caps > 0, -caps, f32(1.0)).astype(f32)


def _all_three(S, E, C, P, variant):
    """[B, M] numpy inputs -> (profile counts, certified, steps, exact),
    plain counts, JAX counts."""
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (S, E, C, P)]
    prof = gf.fill_walk_profile(*args, **_kwargs(variant, S, "torch"))
    plain = gf.greedy_fill_plain(*args, **_kwargs(variant, S, "torch"))
    ref = np.asarray(jax_fill(*(jnp.asarray(x) for x in (S, E, C, P)), chunk=64,
                              **_kwargs(variant, S, "jax")))
    return prof, plain.numpy(), ref


def _subnormal(*xs):
    tiny = np.finfo(f32).tiny
    return any(bool(((np.abs(x) < tiny) & (x != 0)).any()) for x in xs)


def _assert_same(S, E, C, P, variant):
    prof, plain, ref = _all_three(S, E, C, P, variant)
    np.testing.assert_array_equal(prof[0].numpy(), plain)
    if not _subnormal(S, E, C, P):  # XLA:CPU flushes subnormals to zero (ROADMAP Queue 3, L2)
        np.testing.assert_array_equal(plain, ref)
    return prof


def _instance(rng, B, M, variant, budget_scale=1.0):
    S = rng.uniform(-100, 50, (B, M)).astype(f32)
    E = rng.uniform(0.5, 10, (B, M)).astype(f32)
    C = rng.integers(0, 50, (B, M)).astype(f32)
    P = (rng.uniform(1, 500, B) * budget_scale).astype(f32)
    if variant == "sort_key":
        S = _sort_key_scores(C)
    return S, E, C, P


def _reaches(x, e, k):
    """floor(x / e) >= k in numpy's float32 division (the definition)."""
    return np.floor(x / e) >= k


# ---- thresholds against their definition -----------------------------------

CAP_KINDS = {
    "integer-small": lambda rng, n: rng.integers(0, 1000, n).astype(f32),
    "integer-large": lambda rng, n: np.concatenate(
        [rng.integers(0, 2**24, n - 4), [0, 1, 2**24 - 2, 2**24 - 1]]).astype(f32),
    "non-integer": lambda rng, n: rng.uniform(0, 5000, n).astype(f32),
    "negative": lambda rng, n: -rng.uniform(0, 1e6, n).astype(f32),
}


@pytest.mark.parametrize("kind", list(CAP_KINDS))
def test_thresholds_are_the_least_budgets_that_reach(kind):
    rng = np.random.default_rng(len(kind))
    n = 60000
    e = np.exp(rng.uniform(np.log(1e-3), np.log(1e4), n)).astype(f32)
    cap = CAP_KINDS[kind](rng, n)
    T, U = (x.numpy() for x in gf.fill_thresholds(torch.from_numpy(e), torch.from_numpy(cap)))
    k = np.maximum(f32(1), np.ceil(cap))
    assert np.isfinite(T).all() and np.isfinite(U).all()  # every search settled
    below_T = np.nextafter(T, f32(-np.inf))
    below_U = np.nextafter(U, f32(-np.inf))
    assert _reaches(T, e, k).all() and not _reaches(below_T, e, k).any()
    assert _reaches(U, e, 1).all() and not _reaches(below_U, e, 1).any()
    np.testing.assert_array_equal(U, e)  # fits >= 1 exactly when P >= e


def test_thresholds_over_every_binade():
    """e from the least normal float32 to 2^100, caps to 2^24 - 1: the
    search settles unless k*e overflows."""
    rng = np.random.default_rng(3)
    n = 40000
    e = (2.0 ** rng.uniform(-126, 100, n)).astype(f32)
    cap = rng.integers(0, 2**24, n).astype(f32)
    T, U = (x.numpy() for x in gf.fill_thresholds(torch.from_numpy(e), torch.from_numpy(cap)))
    k = np.maximum(f32(1), np.ceil(cap))
    overflow = k.astype(np.float64) * e > FLT_MAX * (1 - 2.0**-22)
    assert np.isfinite(T[~overflow]).all()
    ok = np.isfinite(T)
    assert _reaches(T[ok], e[ok], k[ok]).all()
    assert not _reaches(np.nextafter(T[ok], f32(-np.inf)), e[ok], k[ok]).any()
    np.testing.assert_array_equal(U[np.isfinite(U)], e[np.isfinite(U)])


NAN_CASES = {
    "e zero": (0.0, 3.0), "e negative zero": (-0.0, 3.0), "e negative": (-2.0, 3.0),
    "e inf": (np.inf, 3.0), "e nan": (np.nan, 3.0), "e subnormal": (1e-40, 3.0),
    "cap nan": (2.0, np.nan), "cap inf": (2.0, np.inf), "cap -inf": (2.0, -np.inf),
    "cap 2^24": (2.0, 2.0**24), "cap 2^25": (2.0, 2.0**25), "k*e overflows": (3e38, 5.0),
}


@pytest.mark.parametrize("case", list(NAN_CASES))
def test_thresholds_are_nan_where_not_provably_exact(case):
    e, cap = NAN_CASES[case]
    T, U = gf.fill_thresholds(torch.tensor([e, 2.0], dtype=torch.float32),
                              torch.tensor([cap, 3.0], dtype=torch.float32))
    assert T[0].isnan() and U[0].isnan()
    assert T[1] == 6.0 and U[1] == 2.0  # the valid neighbour is unaffected


# ---- the classified walk against the plain walk and the JAX engine ---------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("seed", range(5))
def test_classified_walk_bitwise_vs_plain_and_jax(seed, variant):
    rng = np.random.default_rng(100 + seed)
    M = int(rng.integers(2, 160))
    # budgets from starved to covering every item, so lanes stop, bind,
    # run out of items and certify
    S, E, C, P = _instance(rng, 6, M, variant, budget_scale=M / 8)
    prof = _assert_same(S, E, C, P, variant)
    counts, certified, steps, exact = prof
    assert (steps[certified] == 0).all()
    assert (exact <= steps).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_classified_walk_property(variant, data):
    M = 12
    S = np.array(data.draw(st.lists(st.floats(-100, 50, width=32), min_size=M, max_size=M)), f32)
    E = np.array(data.draw(st.lists(st.floats(0.25, 16, width=32), min_size=M, max_size=M)), f32)
    int_caps = data.draw(st.booleans())
    caps = st.integers(0, 40).map(float) if int_caps else st.floats(-3, 40, width=32)
    C = np.array(data.draw(st.lists(caps, min_size=M, max_size=M)), f32)
    P = f32(data.draw(st.one_of(st.floats(0, 2000, width=32), st.sampled_from([0.0, -1.0]))))
    if variant == "sort_key":
        S = _sort_key_scores(C)
    _assert_same(S[None], E[None], C[None], np.array([P], f32), variant)


def _first_item(S, E, variant):
    key = S if variant == "sort_key" else S / E
    key = np.where(S < 0, key, np.inf)
    return np.argsort(key, axis=-1, kind="stable")[:, 0]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_boundary_budgets_at_the_first_items_thresholds(variant):
    """P0 on, one ulp below and one ulp above T and U of each lane's
    first item: each side of each boundary takes its own class."""
    rng = np.random.default_rng(7)
    S, E, C, _ = _instance(rng, 8, 5, variant)
    S = -np.abs(S) - 1 if variant != "sort_key" else S
    C = np.maximum(C, 2)  # T above U
    if variant == "sort_key":
        S = _sort_key_scores(C)
    first = _first_item(S, E, variant)
    e1 = torch.from_numpy(E[np.arange(8), first])
    T1, U1 = (x.numpy() for x in gf.fill_thresholds(e1, torch.from_numpy(C[np.arange(8), first])))
    assert (T1 > U1).all()
    for edge in (T1, U1):
        for P in (edge, np.nextafter(edge, f32(-np.inf)), np.nextafter(edge, f32(np.inf))):
            _assert_same(S, E, C, P.astype(f32), variant)


def _certifiable_lane(rng, M, variant):
    S = -rng.uniform(1, 100, (1, M)).astype(f32)
    E = rng.uniform(0.5, 10, (1, M)).astype(f32)
    C = rng.integers(1, 50, (1, M)).astype(f32)
    if variant == "sort_key":
        S = _sort_key_scores(C)
    return S, E, C


def _certified(S, E, C, P, variant):
    return bool(gf.fill_walk_profile(*(torch.from_numpy(x) for x in (S, E, C, P)),
                                     **_kwargs(variant, S, "torch"))[1][0])


@pytest.mark.parametrize("variant", ["stop", "nostop", "sort_key"])
def test_certificate_with_the_margin_tight_and_one_ulp_short(variant):
    rng = np.random.default_rng(11)
    S, E, C = _certifiable_lane(rng, 64, variant)
    # the least float32 budget the certificate passes: bisect on the bits
    lo = int(np.array([0], f32).view(np.int32)[0])
    hi = int(np.array([1e9], f32).view(np.int32)[0])
    assert _certified(S, E, C, np.array([hi], np.int32).view(f32), variant)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _certified(S, E, C, np.array([mid], np.int32).view(f32), variant):
            hi = mid
        else:
            lo = mid
    tight = np.array([hi], np.int32).view(f32)
    short = np.nextafter(tight, f32(-np.inf))
    assert _certified(S, E, C, tight, variant) and not _certified(S, E, C, short, variant)
    for P in (tight, short):
        prof = _assert_same(S, E, C, P, variant)
        live = S[0] < 0
        np.testing.assert_array_equal(prof[0].numpy()[0][live], C[0][live])  # caps either way
    assert prof[2][0] == 64  # one ulp short, the lane walks every item


@pytest.mark.parametrize("seed", range(4))
def test_certificate_is_sound(seed):
    """Wherever the certificate passes, the plain walk takes every cap."""
    rng = np.random.default_rng(200 + seed)
    B, M = 64, 96
    S, E, C = (np.concatenate(x) for x in zip(*(_certifiable_lane(rng, M, "stop")
                                                 for _ in range(B))))
    need = (C.astype(np.float64) * E).sum(-1)
    P = (need * rng.uniform(0.999, 1.02, B)).astype(f32)
    args = [torch.from_numpy(x) for x in (S, E, C, P)]
    counts, certified, _, _ = gf.fill_walk_profile(*args)
    plain = gf.greedy_fill_plain(*args).numpy()
    np.testing.assert_array_equal(counts.numpy(), plain)
    assert 0 < int(certified.sum()) < B  # the batch has lanes on both sides
    np.testing.assert_array_equal(plain[certified.numpy()], C[certified.numpy()])


def _fma(a, b, c) -> np.float32:
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    approx = f32(float(x))
    cands = [np.nextafter(approx, f32(-np.inf)), approx, np.nextafter(approx, f32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x), int(v.view(np.uint32)) & 1))


@pytest.mark.parametrize("variant", ["stop", "nostop", "literal"])
def test_classified_walk_keeps_the_fused_budget_update(variant):
    """test_torch_greedy_fill's crafted two-item case: the fused and
    unfused updates differ by an ulp that flips the second take."""
    literal = variant == "literal"
    rng = np.random.default_rng(0)
    while True:
        P = f32(rng.uniform(100, 1000))
        e = f32(rng.uniform(0.5, 10))
        fits = f32(np.floor(P / e))
        t = fits if literal else f32(rng.integers(1, int(fits)))
        fused, unfused = _fma(-t, e, P), f32(P - f32(t * e))
        if fused != unfused and min(fused, unfused) > 0:
            break
    e2 = max(fused, unfused)
    S = np.array([[-1000 * e, -e2]], f32)
    E = np.array([[e, e2]], f32)
    C = np.array([[1.0 if literal else t, 5.0]], f32)
    counts = _assert_same(S, E, C, np.array([P], f32), variant)[0].numpy()
    assert counts[0, 1] == (1.0 if fused >= e2 else 0.0)


ODD = {
    "non-integer caps": lambda S, E, C, P: (S, E, C + f32(0.37), P),
    "negative caps": lambda S, E, C, P: (S, E, -C, P),
    "zero caps": lambda S, E, C, P: (S, E, np.zeros_like(C), P),
    "NaN caps": lambda S, E, C, P: (S, E, np.where(C > 25, f32(np.nan), C), P),
    "caps at 2^24": lambda S, E, C, P: (S, E, np.where(C > 25, f32(2**24), C), P * 1e6),
    "zero budget": lambda S, E, C, P: (S, E, C, np.zeros_like(P)),
    "negative budget": lambda S, E, C, P: (S, E, C, -P),
    "inf budget": lambda S, E, C, P: (S, E, C, np.full_like(P, np.inf)),
    "NaN budget": lambda S, E, C, P: (S, E, C, np.full_like(P, np.nan)),
    "subnormal energies": lambda S, E, C, P: (S, np.where(C > 40, f32(1e-40), E), C, P),
    "infinite energies": lambda S, E, C, P: (S, np.where(C > 45, f32(np.inf), E), C, P),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("odd", list(ODD))
def test_classified_walk_on_odd_inputs(odd, variant):
    rng = np.random.default_rng(21)
    S, E, C, P = ODD[odd](*_instance(rng, 4, 40, "stop", budget_scale=4))
    if variant == "sort_key":
        S = _sort_key_scores(np.nan_to_num(C, nan=7.0))
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (S, E, C, P)]
    prof = gf.fill_walk_profile(*args, **_kwargs(variant, S, "torch"))
    plain = gf.greedy_fill_plain(*args, **_kwargs(variant, S, "torch"))
    np.testing.assert_array_equal(prof[0].numpy(), plain.numpy())


def test_no_stop_lanes_end_below_the_least_U_left():
    """A no-stop lane whose budget falls below every energy left ends
    there, well before its last item, with the plain walk's counts."""
    rng = np.random.default_rng(5)
    M = 400
    S = -rng.uniform(1, 100, (1, M)).astype(f32)
    E = rng.uniform(2, 10, (1, M)).astype(f32)
    C = rng.integers(1, 5, (1, M)).astype(f32)
    prof = _assert_same(S, E, C, np.array([60.0], f32), "nostop")
    assert 0 < int(prof[2][0]) < M // 2


def test_kernel_limits_and_launch_shape():
    assert gf.MAX_ITEMS == 16384
    with pytest.raises(ValueError, match="at most 16384"):
        gf.greedy_fill_cuda(*(torch.zeros((1, 16385)) for _ in range(3)), torch.zeros(1))
    # 12 bytes of shared memory an item at 2 blocks an SM of 512 threads
    assert [gf.threads_for(Mp) for Mp in (2, 64, 1024, 4096, 16384)] == [32, 32, 512, 512, 512]
