"""The port's queueing and drift-plus-penalty functions against the JAX
package on random states. Integral outputs (queues) are bitwise;
elementwise scores are bitwise (both packages compute them unfused,
outside jit); reductions agree to rtol 1e-6 (their sum order differs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dpp as jdpp  # noqa: E402
from repro.core import queueing as jq  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dpp as tdpp  # noqa: E402
from repro_torch.core import queueing as tq  # noqa: E402

f32 = np.float32
RTOL = 1e-6


def _case(seed, M=37, N=11):
    rng = np.random.default_rng(seed)
    spec = jq.NetworkSpec(pe=rng.uniform(1, 8, M).astype(f32),
                          pc=rng.uniform(2, 100, (M, N)).astype(f32),
                          Pe=float(rng.uniform(1e3, 5e3)),
                          Pc=rng.uniform(1e3, 5e4, N).astype(f32))
    state = jq.NetworkState(Qe=jnp.asarray(rng.integers(0, 500, M).astype(f32)),
                            Qc=jnp.asarray(rng.integers(0, 500, (M, N)).astype(f32)))
    act = jq.Action(d=jnp.asarray(rng.integers(0, 30, (M, N)).astype(f32)),
                    w=jnp.asarray(rng.integers(0, 30, (M, N)).astype(f32)))
    a = rng.integers(0, 400, M).astype(f32)
    Ce, Cc = f32(rng.uniform(0, 700)), rng.uniform(0, 700, N).astype(f32)
    tact = tq.Action(d=torch.from_numpy(np.array(act.d)), w=torch.from_numpy(np.array(act.w)))
    return (spec, state, act, a, Ce, Cc,
            convert.from_reference(spec, "cpu"), convert.from_reference(state, "cpu"), tact)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL)


@pytest.mark.parametrize("seed", range(3))
def test_step_and_energies(seed):
    spec, state, act, a, Ce, Cc, tspec, tstate, tact = _case(seed)
    nxt, tnxt = jq.step(state, act, jnp.asarray(a)), tq.step(tstate, tact, torch.from_numpy(a))
    np.testing.assert_array_equal(tnxt.Qe.numpy(), np.asarray(nxt.Qe))
    np.testing.assert_array_equal(tnxt.Qc.numpy(), np.asarray(nxt.Qc))
    pe, pc, _, _ = tspec.as_arrays()
    _close(tq.edge_energy(pe, tact.d), jq.edge_energy(jnp.asarray(spec.pe), act.d))
    _close(tq.cloud_energy(pc, tact.w), jq.cloud_energy(jnp.asarray(spec.pc), act.w))
    _close(tq.emissions(tspec, tact, torch.tensor(Ce), torch.from_numpy(Cc)),
           jq.emissions(spec, act, Ce, jnp.asarray(Cc)))
    _close(tq.lyapunov(tnxt), jq.lyapunov(nxt))
    _close(tq.drift_bound_B(tspec, 400.0, device="cpu"), jq.drift_bound_B(spec, 400.0))
    assert bool(tq.is_feasible(tspec, tact)) == bool(jq.is_feasible(spec, act))


def test_is_feasible_flags():
    spec, _, act, _, _, _, tspec, _, tact = _case(0)
    zero = tq.Action(d=torch.zeros_like(tact.d), w=torch.zeros_like(tact.w))
    assert bool(tq.is_feasible(tspec, zero))
    frac = tq.Action(d=zero.d + 0.5, w=zero.w)
    assert not bool(tq.is_feasible(tspec, frac))
    neg = tq.Action(d=zero.d, w=zero.w - 1)
    assert not bool(tq.is_feasible(tspec, neg))
    big = tq.Action(d=zero.d + 1e6, w=zero.w)
    assert bool(tq.is_feasible(tspec, big)) == bool(
        jq.is_feasible(spec, jq.Action(d=jnp.asarray(big.d.numpy()), w=act.w * 0)))


def test_init_state_and_spec_shapes():
    st = tq.init_state(4, 3, device="cpu")
    assert st.Qe.shape == (4,) and st.Qc.shape == (4, 3) and st.Qc.dtype == torch.float32
    assert (st.M, st.N) == (4, 3)
    spec = convert.spec_from_numpy(np.ones(4), np.ones((4, 3)), 10.0, np.ones(3), device="cpu")
    assert (spec.M, spec.N) == (4, 3)
    assert all(x.dtype == torch.float32 for x in spec.as_arrays())


@pytest.mark.parametrize("seed", range(3))
def test_dpp_functions(seed):
    spec, state, act, a, Ce, Cc, tspec, tstate, tact = _case(seed)
    V = 0.05
    pe, pc, _, _ = tspec.as_arrays()
    Ce_t, Cc_t = torch.tensor(Ce), torch.from_numpy(Cc)
    np.testing.assert_array_equal(
        tdpp.dispatch_scores(tstate, pe, Ce_t, V).numpy(),
        np.asarray(jdpp.dispatch_scores(state, jnp.asarray(spec.pe), Ce, V)))
    np.testing.assert_array_equal(
        tdpp.processing_scores(tstate, pc, Cc_t, V).numpy(),
        np.asarray(jdpp.processing_scores(state, jnp.asarray(spec.pc), jnp.asarray(Cc), V)))
    _close(tdpp.surrogate_value(tstate, tspec, tact, Ce_t, Cc_t, V),
           jdpp.surrogate_value(state, spec, act, Ce, jnp.asarray(Cc), V))
    a_t = torch.from_numpy(a)
    _close(tdpp.drift_plus_penalty(tstate, tspec, tact, a_t, Ce_t, Cc_t, V),
           jdpp.drift_plus_penalty(state, spec, act, jnp.asarray(a), Ce, jnp.asarray(Cc), V))
    B = float(jq.drift_bound_B(spec, 400.0))
    _close(tdpp.lemma1_rhs(tstate, tspec, tact, a_t, Ce_t, Cc_t, V, B),
           jdpp.lemma1_rhs(state, spec, act, jnp.asarray(a), Ce, jnp.asarray(Cc), V, B))
