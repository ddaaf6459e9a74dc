"""The port's policies against the JAX policies (under jit) and the
literal Algorithm-1 transcription, bitwise.

The JAX policy runs under `jax.jit`, because XLA:CPU contracts the score
pass into FMAs only there; the port's plain versions round the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import policies as jp  # noqa: E402
from repro.core.queueing import NetworkSpec as JSpec  # noqa: E402
from repro.core.queueing import NetworkState as JState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core.queueing import is_feasible  # noqa: E402

f32 = np.float32
SHAPES = [(5, 5), (64, 16), (300, 7)]
VARIANTS = {
    "stop": dict(stop_at_first_unfit=True),
    "nostop": dict(stop_at_first_unfit=False),
    "literal": dict(literal_edge_budget=True),
}


def _instance(rng, M, N):
    spec = JSpec(
        pe=rng.uniform(1, 8, M).astype(f32),
        pc=rng.uniform(2, 100, (M, N)).astype(f32),
        Pe=float(rng.uniform(100, 2000)),
        Pc=rng.uniform(100, 5000, N).astype(f32),
    )
    state = JState(Qe=jnp.asarray(rng.integers(0, 1000, M).astype(f32)),
                   Qc=jnp.asarray(rng.integers(0, 1000, (M, N)).astype(f32)))
    Ce = f32(rng.uniform(0, 700))
    Cc = rng.uniform(0, 700, N).astype(f32)
    return spec, state, Ce, Cc


def _port_args(spec, state, Ce, Cc):
    return (convert.from_reference(state, "cpu"), convert.from_reference(spec, "cpu"),
            torch.tensor(Ce), torch.from_numpy(Cc))


def _assert_action(got, want):
    np.testing.assert_array_equal(got.d.numpy(), np.asarray(want.d))
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("M,N", SHAPES)
def test_carbon_intensity_bitwise_vs_jax_and_literal(M, N, variant):
    rng = np.random.default_rng(M * 100 + N)
    kw = VARIANTS[variant]
    for _ in range(2):
        spec, state, Ce, Cc = _instance(rng, M, N)
        ref_pol = jp.CarbonIntensityPolicy(V=0.05, **kw)
        ref = jax.jit(lambda s, ce, cc: ref_pol(s, spec, ce, cc, None, None))(state, Ce, Cc)
        st, sp, ce, cc = _port_args(spec, state, Ce, Cc)
        got = tp.CarbonIntensityPolicy(V=0.05, fill_chunk=7, **kw)(st, sp, ce, cc)
        _assert_action(got, ref)
        lit = tp.literal_algorithm1(
            st, sp, Ce, Cc, 0.05,
            stop_at_first_unfit=kw.get("stop_at_first_unfit", True),
            literal_edge_budget=kw.get("literal_edge_budget", False),
        )
        _assert_action(got, lit)
        assert bool(is_feasible(sp, got))


@pytest.mark.parametrize("M,N", SHAPES)
def test_queue_length_bitwise_vs_jax(M, N):
    rng = np.random.default_rng(M + N)
    for _ in range(2):
        spec, state, Ce, Cc = _instance(rng, M, N)
        state = state._replace(Qc=state.Qc.at[0].set(3.0))  # a tied row: n1 = first index
        ref = jax.jit(lambda s: jp.QueueLengthPolicy()(s, spec, None, None, None, None))(state)
        st, sp, _, _ = _port_args(spec, state, Ce, Cc)
        got = tp.QueueLengthPolicy(fill_chunk=3)(st, sp, None, None)
        _assert_action(got, ref)
        assert bool(is_feasible(sp, got))


def test_fill_chunk_changes_no_action():
    rng = np.random.default_rng(9)
    spec, state, Ce, Cc = _instance(rng, 64, 8)
    args = _port_args(spec, state, Ce, Cc)
    a = tp.CarbonIntensityPolicy(fill_chunk=1)(*args)
    b = tp.CarbonIntensityPolicy(fill_chunk=512)(*args)
    assert torch.equal(a.d, b.d) and torch.equal(a.w, b.w)


@pytest.mark.parametrize("M,N", SHAPES)
def test_random_policy_feasible(M, N):
    rng = np.random.default_rng(1)
    spec, state, Ce, Cc = _instance(rng, M, N)
    st, sp, ce, cc = _port_args(spec, state, Ce, Cc)
    for key in range(5):
        act = tp.RandomPolicy()(st, sp, ce, cc, None, key)
        assert bool(is_feasible(sp, act))
        assert act.d.shape == (M, N) and act.w.shape == (M, N)
