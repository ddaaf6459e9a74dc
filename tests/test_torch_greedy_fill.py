"""The port's greedy fill against the JAX engine and a sequential oracle,
bitwise.

`repro_torch.core.policies.greedy_fill` (the plain version on the CPU;
the CUDA kernel is held against it on the card) must give the counts of
`repro.core.policies.greedy_fill` bit for bit, in every variant
(stop_at_first_unfit x literal_edge_budget x sort_key), for any chunk.
The oracle is a float32 transcription of the sequential walk whose
budget update is single-rounded, as XLA:CPU computes it (it contracts
`P - t*e` into one FMA); the crafted case below is one where the
unfused update would flip a later take.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import greedy_fill as jax_fill  # noqa: E402
from repro_torch.core.policies import greedy_fill  # noqa: E402

f32 = np.float32


def _fma(a, b, c) -> np.float32:
    """Correctly rounded float32 a*b + c, from the exact rational."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    approx = f32(float(x))
    cands = [np.nextafter(approx, f32(-np.inf)), approx, np.nextafter(approx, f32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x), int(v.view(np.uint32)) & 1))


def seq_fill(scores, e, caps, budget, stop=True, literal=False, sort_key=None, fused=True):
    """float32 sequential walk in the reference's op order (the oracle)."""
    key = sort_key if sort_key is not None else scores / e
    key = np.where(scores < 0, key, np.inf)
    order = np.argsort(key, kind="stable")
    P = f32(budget)
    stopped = False
    take = np.zeros_like(scores)
    for m in order:
        if not np.isfinite(key[m]):
            continue
        fits = f32(np.floor(P / e[m]))
        can = (fits > 0) and (scores[m] < 0) and (not stopped)
        t = f32(min(caps[m], fits)) if can else f32(0.0)
        take[m] = t
        step = fits if literal else t
        if can or not literal:
            P = _fma(-step, e[m], P) if fused else f32(P - f32(step * e[m]))
        if stop or literal:
            stopped = stopped or fits <= 0
    return take


VARIANTS = {
    "stop": dict(stop_at_first_unfit=True),
    "nostop": dict(stop_at_first_unfit=False),
    "literal": dict(literal_edge_budget=True),
    "sort_key": dict(stop_at_first_unfit=False),
}


def _instance(rng, M, variant):
    scores = rng.uniform(-100, 50, M).astype(f32)
    e = rng.uniform(0.5, 10, M).astype(f32)
    caps = rng.integers(0, 50, M).astype(f32)
    budget = f32(rng.uniform(1, 500))
    if variant == "sort_key":  # QueueLengthPolicy's ordering
        scores = np.where(caps > 0, -caps, f32(1.0)).astype(f32)
    return scores, e, caps, budget


def _both(scores, e, caps, budget, variant, chunk):
    kw = dict(VARIANTS[variant])
    jkw, tkw = dict(kw), dict(kw)
    if variant == "sort_key":
        jkw["sort_key"], tkw["sort_key"] = jnp.asarray(scores), torch.from_numpy(scores)
    ref = np.asarray(jax_fill(jnp.asarray(scores), jnp.asarray(e), jnp.asarray(caps),
                              jnp.asarray(budget), chunk=chunk, **jkw))
    got = greedy_fill(torch.from_numpy(scores), torch.from_numpy(e), torch.from_numpy(caps),
                      torch.tensor(budget), chunk=chunk, **tkw).numpy()
    return got, ref


def _oracle(scores, e, caps, budget, variant):
    return seq_fill(scores, e, caps, budget,
                    stop=VARIANTS[variant].get("stop_at_first_unfit", True),
                    literal=variant == "literal",
                    sort_key=scores if variant == "sort_key" else None)


@pytest.mark.parametrize("chunk", [3, 64])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("seed", range(5))
def test_fill_bitwise_vs_jax_and_oracle(seed, variant, chunk):
    rng = np.random.default_rng(seed)
    scores, e, caps, budget = _instance(rng, int(rng.integers(2, 128)), variant)
    got, ref = _both(scores, e, caps, budget, variant, chunk)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _oracle(scores, e, caps, budget, variant))


@pytest.mark.parametrize("degenerate", ["zero-budget", "nonneg-scores", "zero-caps", "M=1"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fill_degenerate_corners(variant, degenerate):
    rng = np.random.default_rng(11)
    scores, e, caps, budget = _instance(rng, 1 if degenerate == "M=1" else 33, variant)
    if degenerate == "zero-budget":
        budget = f32(0.0)
    elif degenerate == "nonneg-scores":
        scores = np.abs(scores)
    elif degenerate == "zero-caps":
        caps = np.zeros_like(caps)
    got, ref = _both(scores, e, caps, budget, variant, chunk=5)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _oracle(scores, e, caps, budget, variant))


def test_fill_batched_lanes_match_single_lanes_and_jax():
    rng = np.random.default_rng(5)
    B, M = 9, 120
    S = rng.uniform(-100, 50, (B, M)).astype(f32)
    E = rng.uniform(0.5, 10, (B, M)).astype(f32)
    C = rng.integers(0, 50, (B, M)).astype(f32)
    P = rng.uniform(1, 500, B).astype(f32)
    full = greedy_fill(*(torch.from_numpy(x) for x in (S, E, C, P)), chunk=16).numpy()
    ref = np.asarray(jax_fill(*(jnp.asarray(x) for x in (S, E, C, P)), chunk=16))
    np.testing.assert_array_equal(full, ref)
    for b in range(B):
        one = greedy_fill(*(torch.from_numpy(x[b]) for x in (S, E, C)), torch.tensor(P[b]))
        np.testing.assert_array_equal(full[b], one.numpy())


def _fused_budget_case(literal):
    """Two items: after the first, the fused and unfused budget updates
    differ by an ulp, and the second item's energy is the larger of the
    two, so floor(P/e) of the second item tells them apart."""
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
    scores = np.array([-1000 * e, -e2], f32)  # key order: item 0 first
    caps = np.array([1.0 if literal else t, 5.0], f32)
    return scores, np.array([e, e2], f32), caps, P, fused >= e2


@pytest.mark.parametrize("variant", ["stop", "nostop", "literal"])
def test_fill_budget_update_is_fused_like_the_reference(variant):
    scores, e, caps, P, second_fits = _fused_budget_case(variant == "literal")
    got, ref = _both(scores, e, caps, P, variant, chunk=64)
    np.testing.assert_array_equal(got, ref)
    assert got[1] == (1.0 if second_fits else 0.0)
    oracle = _oracle(scores, e, caps, P, variant)
    np.testing.assert_array_equal(got, oracle)
    unfused = seq_fill(scores, e, caps, P, stop=variant != "nostop",
                       literal=variant == "literal", fused=False)
    assert not np.array_equal(got, unfused)  # the case does tell the two apart


def test_chunk_must_be_positive():
    with pytest.raises(ValueError, match="chunk"):
        greedy_fill(torch.zeros(3), torch.ones(3), torch.ones(3), torch.tensor(1.0), chunk=0)
