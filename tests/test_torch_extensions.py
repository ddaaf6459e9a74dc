"""The port's `core.extensions` against the JAX package's.

ThresholdPolicy (QueueLengthPolicy's stacked fill, its `w` gated by Cc <
threshold) is JAX's action bitwise under jit, with and without lanes,
and through `simulate`, the fleet (JAX's vmapped program; lanes against
each run alone), the V sweep and `serve_loop`: queues and counts bitwise, emissions
rtol 1e-6. `tests/test_extensions.py`'s runs become port tests against
JAX: the 400-slot unstable threshold run, and the AdaptiveVController
loop. JAX's own test drives that loop eagerly, where XLA does not
contract the score pass (ROADMAP hazard 1); the port is held to the
policy step under `jax.jit` with V an argument, which is how every JAX
loop runs it. The oracles are JAX's values exactly and lower-bound every
policy's emissions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.core.extensions as JX  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.configs import fleet_scenarios as jfs  # noqa: E402
from repro.configs import paper_workloads as jpw  # noqa: E402
from repro.core.queueing import init_state as j_init_state  # noqa: E402
from repro.core.queueing import step as j_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.configs import paper_workloads as tpw  # noqa: E402
from repro_torch.core import extensions as PX  # noqa: E402
from repro_torch.core.queueing import step as p_step  # noqa: E402
from repro_torch.serve import loop as tserve  # noqa: E402

f32 = np.float32
SCALARS = ("emissions", "cum_emissions", "energy_edge", "energy_cloud")


def _assert_run(got, ref, ints=("Qe", "Qc", "dispatched", "processed")):
    for name in ints:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in SCALARS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("threshold", [5.0, 150.0, 200.0, 1e9])
def test_threshold_actions_are_jax(threshold):
    """One slot's action from random queues; a lane axis (F = 3) equals
    each lane alone. Tolerance: none."""
    rng = np.random.default_rng(int(threshold) % 97)
    M, N = 12, 5
    fields = dict(pe=rng.uniform(1, 8, M).astype(f32), pc=rng.uniform(2, 100, (M, N)).astype(f32),
                  Pe=400.0, Pc=rng.uniform(100, 2000, N).astype(f32))
    Qe = rng.integers(0, 300, (3, M)).astype(f32)
    Qc = rng.integers(0, 300, (3, M, N)).astype(f32)
    Cc = rng.uniform(0, 400, (3, N)).astype(f32)
    Cc[0, 1] = f32(threshold)  # the gate's edge: not below
    jpol, tpol = JX.ThresholdPolicy(threshold), PX.ThresholdPolicy(threshold)
    spec = J.NetworkSpec(**fields)
    lanes = tpol(P.NetworkState(Qe=torch.from_numpy(Qe), Qc=torch.from_numpy(Qc)),
                 P.NetworkSpec(*(torch.from_numpy(np.stack([np.asarray(fields[k], f32)] * 3))
                                 for k in ("pe", "pc", "Pe", "Pc"))),
                 torch.zeros(3), torch.from_numpy(Cc))
    for f in range(3):
        ref = jax.jit(lambda s, cc: jpol(s, spec, jnp.float32(0), cc, None, None))(
            J.NetworkState(Qe=jnp.asarray(Qe[f]), Qc=jnp.asarray(Qc[f])), jnp.asarray(Cc[f]))
        got = tpol(P.NetworkState(Qe=torch.from_numpy(Qe[f]), Qc=torch.from_numpy(Qc[f])),
                   P.NetworkSpec(**fields), torch.tensor(f32(0)), torch.from_numpy(Cc[f]))
        for name in ("d", "w"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
            assert torch.equal(getattr(lanes, name)[f], getattr(got, name))
        assert float(got.w[:, 1].sum()) == 0.0 or f != 0


def test_threshold_simulate_matches_jax_and_serve():
    """The paper setup on Fig. 2's streams, threshold 250, T = 60."""
    T = 60
    ref = jax.jit(lambda k: J.simulate(JX.ThresholdPolicy(250.0), jpw.paper_spec(),
                                       J.RandomCarbonSource(N=5), J.UniformArrivals(M=5), T, k))(
        jax.random.PRNGKey(0))
    args = (PX.ThresholdPolicy(250.0), tpw.paper_spec(), P.RandomCarbonSource(N=5),
            P.UniformArrivals(M=5), T, 0)
    got = P.simulate(*args, device="cpu")
    _assert_run(got, ref)
    rep = tserve.serve_loop(*args, device="cpu")
    np.testing.assert_array_equal(rep.emissions, got.emissions.numpy())
    assert torch.equal(rep.state.Qe, got.Qe[-1]) and torch.equal(rep.state.Qc, got.Qc[-1])


def test_threshold_fleet_matches_jax_and_lanes_alone():
    T = 24
    jf = jfs.build_fleet(("diurnal", "bursty", "overload"), per_kind=2, M=5, N=5, Tc=24, seed=0)
    ref = jax.jit(lambda k: J.simulate_fleet(JX.ThresholdPolicy(180.0), jf, T, k))(
        jax.random.PRNGKey(2))
    fleet = convert.fleet_from_reference(jf)
    pol = PX.ThresholdPolicy(180.0)
    got = P.simulate_fleet(pol, fleet, T, 2, device="cpu")
    _assert_run(got, ref)
    keys = R.split(R.PRNGKey(2, device="cpu"), fleet.F)
    for f in (1, 4):
        spec = P.NetworkSpec(*(x[f] for x in fleet.spec))
        one = P.simulate(pol, spec, P.TableCarbonSource(table=fleet.carbon[f]),
                         P.FleetArrivals(amax=fleet.arrival_amax[f]), T, keys[f], device="cpu")
        for name in ("Qe", "Qc", "emissions", "dispatched", "processed"):
            assert torch.equal(getattr(got, name)[f], getattr(one, name)), (f, name)


def test_threshold_vsweep_matches_jax():
    """A V sweep whose policy ignores V (ThresholdPolicy has none): every
    lane is the single run, on JAX's vmapped program as on the port's."""
    Vs, T = (0.01, 0.2), 20
    ref = jax.jit(lambda k: J.simulate_vsweep(
        lambda V: JX.ThresholdPolicy(150.0), jnp.asarray(Vs, jnp.float32), jpw.paper_spec(),
        J.RandomCarbonSource(N=5), J.UniformArrivals(M=5), T, k))(jax.random.PRNGKey(3))
    got = P.simulate_vsweep(lambda V: PX.ThresholdPolicy(150.0), Vs, tpw.paper_spec(),
                            P.RandomCarbonSource(N=5), P.UniformArrivals(M=5), T, 3, device="cpu")
    _assert_run(got, ref)
    assert torch.equal(got.Qc[0], got.Qc[1])


def test_threshold_policy_unstable_when_too_strict_like_jax():
    """tests/test_extensions.py's 400-slot run at threshold 5: queues
    bitwise JAX's, and the backlog grows linearly."""
    T = 400
    ref = jax.jit(lambda k: J.simulate(JX.ThresholdPolicy(threshold=5.0), jpw.paper_spec(),
                                       J.RandomCarbonSource(N=5), J.UniformArrivals(M=5, amax=400),
                                       T, k, record="summary"))(jax.random.PRNGKey(0))
    got = P.simulate(PX.ThresholdPolicy(threshold=5.0), tpw.paper_spec(),
                     P.RandomCarbonSource(N=5), P.UniformArrivals(M=5, amax=400), T, 0,
                     record="summary", device="cpu")
    _assert_run(got, ref)
    full = P.simulate(PX.ThresholdPolicy(threshold=5.0), tpw.paper_spec(),
                      P.RandomCarbonSource(N=5), P.UniformArrivals(M=5, amax=400), T, 0,
                      record=10, device="cpu")
    backlog = (full.Qc.sum((1, 2)) + full.Qe.sum(1)).numpy()  # every 10th slot
    assert backlog[-10:].mean() > 3 * max(backlog[:10].mean(), 1.0)


def test_adaptive_v_loop_matches_jitted_policy_steps():
    """tests/test_extensions.py's controller loop (T = 250, target 30000):
    every slot's action, state and V bitwise the JAX policy step under
    jit with V an argument; the backlog held near its target."""
    spec_j, spec_p = jpw.paper_spec(), tpw.paper_spec()
    jc, ja = J.RandomCarbonSource(N=5), J.UniformArrivals(M=5, amax=400)
    pc, pa = P.RandomCarbonSource(N=5), P.UniformArrivals(M=5, amax=400)
    kc, ka = jax.random.split(jax.random.PRNGKey(1))
    tk = R.split(R.PRNGKey(1, device="cpu"), 2)
    jstep = jax.jit(lambda s, ce, cc, a, V: J.CarbonIntensityPolicy(V=V)(s, spec_j, ce, cc, a,
                                                                         None))
    ctrl_j = JX.AdaptiveVController(target_backlog=30000.0, V=0.001)
    ctrl_p = PX.AdaptiveVController(target_backlog=30000.0, V=0.001)
    sj, sp = j_init_state(5, 5), P.init_state(5, 5, device="cpu")
    backlogs = []
    for t in range(250):
        Ce, Cc = jc(jnp.asarray(t), kc)
        a = ja(jnp.asarray(t), ka)
        act = jstep(sj, Ce, Cc, a, jnp.float32(ctrl_j.V))
        sj = j_step(sj, act, a)
        tCe, tCc = pc(t, tk[0], "cpu")
        ta = pa(t, tk[1], "cpu")
        pol = ctrl_p.policy()
        assert isinstance(pol, P.CarbonIntensityPolicy) and pol.V == ctrl_p.V
        tact = pol(sp, spec_p, tCe, tCc, ta, None)
        sp = p_step(sp, tact, ta)
        np.testing.assert_array_equal(tact.w.numpy(), np.asarray(act.w))
        np.testing.assert_array_equal(sp.Qc.numpy(), np.asarray(sj.Qc))
        np.testing.assert_array_equal(sp.Qe.numpy(), np.asarray(sj.Qe))
        b_j = float(sj.Qe.sum() + sj.Qc.sum())
        b_p = float(sp.Qe.sum() + sp.Qc.sum())
        assert b_j == b_p
        backlogs.append(b_p)
        assert ctrl_j.update(b_j) == ctrl_p.update(b_p)
    tail = np.asarray(backlogs[-80:])
    assert 30000.0 / 5 < tail.mean() < 3 * 30000.0
    assert ctrl_p.v_min < ctrl_p.V < ctrl_p.v_max


def test_adaptive_v_update_direction_and_clamps():
    """tests/test_extensions.py's update anchor, on the port's class."""
    c = PX.AdaptiveVController(target_backlog=100.0, V=0.05, step=1.15, band=0.25)
    v = c.V
    assert c.update(1000.0) < v
    v = c.V
    assert c.update(1.0) > v
    v = c.V
    assert c.update(100.0) == v and c.update(124.9) == v and c.update(75.1) == v
    lo = PX.AdaptiveVController(target_backlog=100.0, V=1e-4)
    for _ in range(10):
        lo.update(1e9)
    assert lo.V == pytest.approx(lo.v_min)
    hi = PX.AdaptiveVController(target_backlog=100.0, V=9.9)
    for _ in range(10):
        hi.update(0.0)
    assert hi.V == pytest.approx(hi.v_max)


def test_oracles_equal_jax_and_bound_every_policy():
    """Both oracles give JAX's values exactly on the same numpy inputs (and
    on the port's CPU tensors), and neither exceeds any policy's emissions
    (rtol 1e-6 on the horizon bound, as the JAX test allows)."""
    spec = tpw.paper_spec()
    T = 200
    ctab = P.materialize(P.RandomCarbonSource(N=5), T, R.split(R.PRNGKey(4, device="cpu"), 3)[0],
                         device="cpu")
    jtab = np.asarray(J.carbon.materialize(J.RandomCarbonSource(N=5), T,
                                           jax.random.split(jax.random.PRNGKey(4), 3)[0]))
    np.testing.assert_array_equal(ctab, jtab)
    for pol in (P.CarbonIntensityPolicy(V=0.05), P.QueueLengthPolicy(),
                PX.ThresholdPolicy(250.0), P.ExactDPPPolicy(V=0.05, grid=64)):
        r = P.simulate(pol, spec, P.RandomCarbonSource(N=5), P.UniformArrivals(M=5), T, 4,
                       device="cpu")
        realized = float(r.cum_emissions[-1])
        ee, ec = r.energy_edge.numpy(), r.energy_cloud.numpy()
        lb = PX.oracle_emissions_for_work(spec, ctab, float(ee.sum()), ec.sum())
        assert lb == JX.oracle_emissions_for_work(jpw.paper_spec(), jtab, float(ee.sum()),
                                                  ec.sum())
        assert lb == PX.oracle_emissions_for_work(spec, torch.from_numpy(ctab),
                                                  torch.tensor(ee.sum()), torch.tensor(ec.sum()))
        assert lb <= realized * 1.001
        for h in (1, 4, 16, None):
            b = PX.oracle_emissions_horizon(ctab, ee, ec, horizon=h)
            assert b == JX.oracle_emissions_horizon(jtab, ee, ec, horizon=h)
            assert b == PX.oracle_emissions_horizon(torch.from_numpy(ctab), r.energy_edge,
                                                    r.energy_cloud, horizon=h)
            assert b <= realized * (1 + 1e-6)
    with pytest.raises(ValueError, match="columns"):
        PX.oracle_emissions_horizon(ctab, ee, ec[:, :3])


def test_extensions_exported_like_jax():
    import repro.core as JC

    for name in ("AdaptiveVController", "ThresholdPolicy", "oracle_emissions_for_work",
                 "oracle_emissions_horizon", "ExactDPPPolicy"):
        assert name in P.__all__ and hasattr(JC, name)
