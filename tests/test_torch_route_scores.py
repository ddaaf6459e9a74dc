"""The port's WAN route-score pass against the JAX reference, bitwise.

`repro_torch.kernels.route_score.route_scores_plain` (what the port runs
on the CPU, and what the CUDA kernel is held against on the card) has two
rounding modes, each what XLA:CPU computes where the JAX package calls
the pass:

* with `extra`: rc = (fma(VCt, pt, extra) + Qt) + Qcr, as
  `jax.jit(route_scores_ref)` and the interpret-mode Pallas kernel give;
* without it: rc = fma(VCt, pt, Qt) + Qcr, as `NetworkAwareDPPPolicy`
  gives inside a scan at route_compute_weight 0 (XLA folds the zero
  `extra` and contracts the next add).

In both, b = fma(V*Ce, pe, min rc) - Qe. A crafted row, where the fused
and unfused rc differ by one ulp and the ulp flips l1, pins each mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.queueing import NetworkSpec as JSpec  # noqa: E402
from repro.core.queueing import NetworkState as JState  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import route_scores_ref  # noqa: E402
from repro.network import NetworkAwareDPPPolicy as JAware  # noqa: E402
from repro.network import make_graph as jmake_graph  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

f32 = np.float32
_ref_jit = jax.jit(route_scores_ref)


def _inputs(rng, M, L):
    return dict(
        Qt=rng.integers(0, 500, (M, L)).astype(f32),
        pt=rng.uniform(0, 5, (M, L)).astype(f32),
        Qcr=rng.integers(0, 900, (M, L)).astype(f32),
        extra=rng.uniform(0, 50, (M, L)).astype(f32),
        Qe=rng.integers(0, 900, M).astype(f32),
        pe=rng.uniform(1, 8, M).astype(f32),
        VCt=rng.uniform(0, 40, L).astype(f32),
        V_Ce=f32(rng.uniform(0, 40)),
    )


def _port(a, with_extra=True):
    t = {k: torch.from_numpy(np.atleast_1d(v).copy()) for k, v in a.items()}
    extra = t["extra"] if with_extra else None
    return ops.route_scores(t["Qt"], t["pt"], t["Qcr"], extra, t["Qe"], t["pe"], t["VCt"],
                            torch.tensor(a["V_Ce"]))


def _ref_args(a):
    return (a["Qt"], a["pt"], a["Qcr"], a["extra"], a["Qe"], a["pe"], a["VCt"], a["V_Ce"])


def _assert_bitwise(port, ref):
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype


def _in_scan_route_scores(Qt, pt, Qc, Qe, pe, pc, dest, region, Ce, Cc, V=0.05):
    """The JAX policy's own score pass as `simulate(graph=)` runs it: in
    a scan whose carry holds the state and Qt and whose inputs are the
    intensities, with the spec and the graph closed over."""
    M, L = Qt.shape
    spec = JSpec(pe=pe, pc=pc, Pe=1.0, Pc=np.ones(pc.shape[1], f32))
    graph = jmake_graph(dest=dest, bw=np.full(L, 10.0, f32), pt=pt,
                        region=region, size=np.ones(M, f32), primary=np.arange(pc.shape[1]))
    pol = JAware(V=V)
    jpe, jpc, _, _ = spec.as_arrays()

    def body(carry, x):
        state, qt = carry
        ce, cc = x
        return carry, pol._route_scores(state, qt, graph, jpe, jpc, ce, cc,
                                        jnp.asarray(pol.V, jnp.float32))

    carry = (JState(Qe=jnp.asarray(Qe), Qc=jnp.asarray(Qc)), jnp.asarray(Qt))
    _, out = jax.lax.scan(body, carry, (jnp.asarray(Ce)[None], jnp.asarray(Cc)[None]))
    return tuple(np.asarray(x[0]) for x in out)


# the shapes of tests/test_network.py::test_route_kernel_bit_identical
@pytest.mark.parametrize("M,L,bm,bl", [(5, 5, 256, 256), (128, 128, 128, 128),
                                       (100, 37, 64, 16), (257, 129, 128, 128)])
def test_plain_with_extra_bitwise_vs_jit_reference_and_interpret_kernel(M, L, bm, bl):
    rng = np.random.default_rng(M * 100 + L)
    for _ in range(3):
        a = _inputs(rng, M, L)
        port = _port(a)
        _assert_bitwise(port, _ref_jit(*_ref_args(a)))
        pal = jops.route_scores(*(jnp.asarray(x) for x in _ref_args(a)), block_m=bm,
                                block_l=bl, interpret=True)
        _assert_bitwise(port, pal)


def test_unfused_chain_differs_on_random_inputs():
    """So the bitwise tests above do test the rounding."""
    a = _inputs(np.random.default_rng(1), 256, 256)
    unfused = ((a["VCt"][None, :] * a["pt"] + a["extra"]) + a["Qt"]) + a["Qcr"]
    assert np.any(unfused != _port(a)[0].numpy())


@pytest.mark.parametrize("M,N,routes_per_cloud", [(5, 5, 2), (64, 8, 2), (100, 37, 1)])
def test_plain_without_extra_bitwise_vs_the_policy_in_scan(M, N, routes_per_cloud):
    rng = np.random.default_rng(M + N)
    L = N * routes_per_cloud
    dest = np.repeat(np.arange(N), routes_per_cloud)
    region = rng.integers(0, N + 1, L)
    Qt = rng.integers(0, 500, (M, L)).astype(f32)
    Qc = rng.integers(0, 900, (M, N)).astype(f32)
    Qe = rng.integers(0, 900, M).astype(f32)
    pe = rng.uniform(1, 8, M).astype(f32)
    pc = rng.uniform(2, 100, (M, N)).astype(f32)
    Ce, Cc = f32(rng.uniform(0, 700)), rng.uniform(0, 700, N).astype(f32)
    pt = rng.uniform(0, 5, (M, L)).astype(f32)
    ref = _in_scan_route_scores(Qt, pt, Qc, Qe, pe, pc, dest, region, Ce, Cc)
    V = f32(0.05)
    row = np.concatenate([[Ce], Cc]).astype(f32)
    a = dict(Qt=Qt, pt=pt, Qcr=Qc[:, dest], extra=np.zeros_like(Qt),
             Qe=Qe, pe=pe, VCt=(V * row[region]).astype(f32), V_Ce=f32(V * Ce))
    port = _port(a, with_extra=False)
    _assert_bitwise(port, ref)
    # passing the zero `extra` rounds another way, so the modes differ
    assert not np.array_equal(_port(a, with_extra=True)[0].numpy(), ref[0])


# One row, two routes. Route 1: VCt*pt + Qt with VCt = f32(0.05)*298,
# pt = 1.94, Qt = 36 is 64.906 fused and 64.906006 unfused (one ulp
# apart). Route 0 costs exactly the unfused value, so the fused score
# picks route 1 and the unfused one ties and picks route 0.
_VCT1, _PT1, _Q1 = f32(f32(0.05) * f32(298.0)), f32(1.94), f32(36.0)
_FUSED, _UNFUSED = f32(64.906), f32(64.906006)


def test_crafted_row_is_a_one_ulp_flip():
    assert f32(_VCT1 * _PT1) + _Q1 == _UNFUSED
    assert np.nextafter(_FUSED, f32(np.inf)) == _UNFUSED
    got = _port(dict(Qt=np.array([[0.0, _Q1]], f32), pt=np.array([[0.0, _PT1]], f32),
                     Qcr=np.zeros((1, 2), f32), extra=np.zeros((1, 2), f32),
                     Qe=np.zeros(1, f32), pe=np.ones(1, f32), VCt=np.array([1.0, _VCT1], f32),
                     V_Ce=f32(0)), with_extra=False)
    assert got[0][0, 1].item() == _FUSED


def test_crafted_flip_with_extra_matches_jit_reference_and_kernel():
    a = dict(Qt=np.array([[_UNFUSED, 0.0]], f32), pt=np.array([[0.0, _PT1]], f32),
             Qcr=np.zeros((1, 2), f32), extra=np.array([[0.0, _Q1]], f32),
             Qe=np.array([100.0], f32), pe=np.array([2.0], f32),
             VCt=np.array([3.0, _VCT1], f32), V_Ce=f32(1.5))
    port = _port(a)
    assert port[1].item() == 1 and port[0][0, 1].item() == _FUSED
    _assert_bitwise(port, _ref_jit(*_ref_args(a)))
    _assert_bitwise(port, jops.route_scores(*(jnp.asarray(x) for x in _ref_args(a)),
                                            interpret=True))


def test_crafted_flip_without_extra_matches_the_policy_in_scan():
    """Qc = 0, so Qcr = 0; Cc[1] = 298 prices route 1 (region 2)."""
    Qt = np.array([[_UNFUSED, _Q1]], f32)
    pt = np.array([[0.0, _PT1]], f32)
    ref = _in_scan_route_scores(Qt, pt, np.zeros((1, 2), f32), np.array([100.0], f32),
                                np.array([2.0], f32), np.ones((1, 2), f32), dest=[0, 1],
                                region=[1, 2], Ce=f32(30.0), Cc=np.array([60.0, 298.0], f32))
    assert ref[1][0] == 1 and ref[0][0, 1] == _FUSED
    a = dict(Qt=Qt, pt=pt, Qcr=np.zeros((1, 2), f32),
             extra=np.zeros((1, 2), f32), Qe=np.array([100.0], f32), pe=np.array([2.0], f32),
             VCt=np.array([f32(0.05) * f32(60.0), _VCT1], f32), V_Ce=f32(f32(0.05) * f32(30.0)))
    _assert_bitwise(_port(a, with_extra=False), ref)
    # jit(route_scores_ref) with the zero `extra` as an argument does not
    # contract the Qt add: the same row picks route 0 there
    assert int(np.asarray(_ref_jit(*_ref_args(a))[1])[0]) == 0
    assert _port(a, with_extra=True)[1].item() == 0


@pytest.mark.parametrize("with_extra", [True, False])
def test_argmin_ties_go_to_the_first_index(with_extra):
    rng = np.random.default_rng(5)
    M, L = 64, 33
    a = _inputs(rng, M, L)
    a.update(Qt=rng.integers(0, 3, (M, L)).astype(f32), pt=np.zeros((M, L), f32),
             Qcr=np.zeros((M, L), f32), extra=np.zeros((M, L), f32))
    a["Qt"][0] = 7.0  # one long tie
    _, l1, _ = _port(a, with_extra)
    np.testing.assert_array_equal(l1.numpy(), np.argmin(a["Qt"], axis=1).astype(np.int32))
    assert l1[0] == 0
