"""The paper's loop on JAX's random streams, the V sweep and the scenario
fleet, against the JAX package.

`simulate` on the paper's Fig. 2 setup (RandomCarbonSource +
UniformArrivals at PRNGKey(seed)) against `jit(simulate)`;
`simulate_fleet` over every registry kind against JAX's
`jit(simulate_fleet)` (ROADMAP parity hazard c: the port is held to the
vmapped program itself), in full and summary records, with
multi-region-uk fed JAX's table through `convert.fleet_from_reference`;
`simulate_vsweep` against JAX's; `carbon_scores` with a lane axis
against `jit(vmap(carbon_scores_ref))` and the Pallas kernel (interpret)
under vmap. Queues, actions, arrivals and counts are bitwise; emission
and energy series agree to rtol 1e-6 (`cum_emissions` is XLA:CPU's
blocked cumsum, hazard d). The reference's anchors become port tests: a
fleet lane equals its instance run alone, summary scalars equal full
ones, serve equals simulate, an unknown kind raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.network as JN  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.network as PN  # noqa: E402
from repro.configs import fleet_scenarios as jfs  # noqa: E402
from repro.configs import paper_workloads as jpw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.configs import paper_workloads as tpw  # noqa: E402
from repro_torch.core.rng import SlotKey  # noqa: E402
from repro_torch.kernels import carbon_score as cs  # noqa: E402
from repro_torch.serve import loop as tserve  # noqa: E402

SCALARS = ("emissions", "cum_emissions", "energy_edge", "energy_cloud")
COUNTS = ("dispatched", "processed")


def _assert_matches(got, ref):
    for name in ("Qe", "Qc") + COUNTS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in SCALARS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-3, err_msg=name)


def _policies(pname, V=0.05):
    if pname == "carbon":
        return J.CarbonIntensityPolicy(V=V), P.CarbonIntensityPolicy(V=V)
    if pname == "queue":
        return J.QueueLengthPolicy(), P.QueueLengthPolicy()
    return J.RandomPolicy(), P.RandomPolicy()


# ------------------------------------------------- the Fig. 2 setup


@pytest.mark.parametrize("pname", ["carbon", "queue", "random"])
@pytest.mark.parametrize("seed", [0, 7])
def test_simulate_fig2_streams_match_jax(pname, seed):
    """Random carbon and arrivals from PRNGKey(seed), as the paper's Fig. 2
    bench draws them: the port's queues, counts and arrivals bitwise."""
    jpol, tpol = _policies(pname)
    T = 80
    ref = jax.jit(lambda k: J.simulate(jpol, jpw.paper_spec(), J.RandomCarbonSource(N=5),
                                       J.UniformArrivals(M=5), T, k))(jax.random.PRNGKey(seed))
    got = P.simulate(tpol, tpw.paper_spec(), P.RandomCarbonSource(N=5), P.UniformArrivals(M=5),
                     T, seed, device="cpu")
    _assert_matches(got, ref)
    # the arrivals: the queues' step is Qe' = max(Qe - sum d, 0) + a
    k_arrive = R.split(R.PRNGKey(seed, device="cpu"), 3)[1]
    jk_arrive = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    for t in (0, 1, T - 1):
        np.testing.assert_array_equal(P.UniformArrivals(M=5)(t, k_arrive, "cpu").numpy(),
                                      np.asarray(J.UniformArrivals(M=5)(t, jk_arrive)))


@pytest.mark.parametrize("pname", ["carbon", "queue", "random"])
def test_slot_actions_match_jax(pname):
    """One slot's action from the same state, intensities and key."""
    jpol, tpol = _policies(pname)
    rng = np.random.default_rng(3)
    M, N = 40, 6
    fields = dict(pe=rng.uniform(1, 8, M).astype(np.float32),
                  pc=rng.uniform(2, 100, (M, N)).astype(np.float32), Pe=900.0,
                  Pc=rng.uniform(1e3, 5e3, N).astype(np.float32))
    Qe = rng.integers(0, 500, M).astype(np.float32)
    Qc = rng.integers(0, 500, (M, N)).astype(np.float32)
    Ce, Cc = np.float32(321.0), rng.uniform(5, 700, N).astype(np.float32)
    jact = jax.jit(lambda k: jpol(J.NetworkState(Qe=jnp.asarray(Qe), Qc=jnp.asarray(Qc)),
                                  J.NetworkSpec(**fields), jnp.float32(Ce), jnp.asarray(Cc), None,
                                  jax.random.fold_in(k, 5)))(jax.random.PRNGKey(2))
    tact = tpol(P.NetworkState(Qe=torch.from_numpy(Qe), Qc=torch.from_numpy(Qc)),
                P.NetworkSpec(**fields), torch.tensor(Ce), torch.from_numpy(Cc), None,
                SlotKey(R.PRNGKey(2, device="cpu"), 5))
    np.testing.assert_array_equal(tact.d.numpy(), np.asarray(jact.d))
    np.testing.assert_array_equal(tact.w.numpy(), np.asarray(jact.w))


def test_serve_equals_simulate_on_random_streams():
    pol = P.CarbonIntensityPolicy(V=0.05)
    args = (pol, tpw.paper_spec(), P.RandomCarbonSource(N=5), P.UniformArrivals(M=5), 24, 3)
    sim = P.simulate(*args, device="cpu")
    rep = tserve.serve_loop(*args, device="cpu")
    np.testing.assert_array_equal(rep.emissions, sim.emissions.numpy())
    assert torch.equal(rep.state.Qe, sim.Qe[-1]) and torch.equal(rep.state.Qc, sim.Qc[-1])


def test_wan_loop_on_random_streams_matches_jax():
    """The single-lane WAN loop keeps its bits with JAX's key use."""
    M, N = 5, 5
    tspec, _, amax, tgraph = tfs.congested_uplink(M, N, 96, np.random.default_rng((0, 1, 0)))
    jspec, _, _, jgraph = jfs.congested_uplink(M, N, 96, np.random.default_rng((0, 1, 0)))
    T = 40
    # the graph is an argument of the jitted run, as the simulator's scan
    # carries it: closed over, XLA would fold its constants (hazard 1)
    ref = jax.jit(lambda k, g: J.simulate(JN.NetworkAwareDPPPolicy(V=0.1), jspec,
                                          J.RandomCarbonSource(N=N),
                                          J.UniformArrivals(M=M, amax=240), T, k, graph=g))(
        jax.random.PRNGKey(1), jgraph)
    got = P.simulate(PN.NetworkAwareDPPPolicy(V=0.1), tspec, P.RandomCarbonSource(N=N),
                     P.UniformArrivals(M=M, amax=240), T, 1, device="cpu", graph=tgraph)
    for name in ("Qe", "Qc", "Qt", "dispatched", "delivered", "processed"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.emissions.numpy(), np.asarray(ref.emissions), rtol=1e-6)


# ------------------------------------------------------------- the fleet

_FLEETS = {}


def _jax_fleet(kinds, per_kind, M=5, N=5, Tc=24, seed=0):
    k = (tuple(kinds), per_kind, M, N, Tc, seed)
    if k not in _FLEETS:
        _FLEETS[k] = jfs.build_fleet(kinds, per_kind=per_kind, M=M, N=N, Tc=Tc, seed=seed)
    return _FLEETS[k]


def test_build_fleet_equals_jax():
    jf = _jax_fleet(tuple(jfs.SCENARIOS), 2)
    tf = tfs.build_fleet(per_kind=2, Tc=24, seed=0, device="cpu")
    assert list(tfs.SCENARIOS) == list(jfs.SCENARIOS) and tf.F == jf.F == 12
    for name in ("pe", "pc", "Pe", "Pc"):
        np.testing.assert_array_equal(getattr(tf.spec, name), np.asarray(getattr(jf.spec, name)))
    np.testing.assert_array_equal(tf.arrival_amax, np.asarray(jf.arrival_amax))
    # every table bitwise, multi-region-uk's too (float32 op by op, glibc's
    # sinf, the twin's normal over XLA's log1p)
    np.testing.assert_array_equal(tf.carbon, np.asarray(jf.carbon))
    with pytest.raises(KeyError, match="unknown scenario"):
        tfs.build_fleet(["diurnal", "no-such-kind"], per_kind=1, device="cpu")


@pytest.mark.parametrize("record", ["full", "summary", 8])
@pytest.mark.parametrize("pname", ["carbon", "queue"])
def test_simulate_fleet_matches_jax(pname, record):
    """Every registry kind, two lanes each (F = 12), against JAX's
    vmapped simulate_fleet under jit."""
    jpol, tpol = _policies(pname)
    jf = _jax_fleet(tuple(jfs.SCENARIOS), 2)
    T = 48
    ref = jax.jit(lambda k: J.simulate_fleet(jpol, jf, T, k, record=record))(
        jax.random.PRNGKey(0))
    got = P.simulate_fleet(tpol, convert.fleet_from_reference(jf), T, 0, record=record,
                           device="cpu")
    assert got.Qc.shape == np.asarray(ref.Qc).shape
    _assert_matches(got, ref)


def test_fleet_lane_equals_its_instance_alone():
    """The reference's anchor: lane f of the fleet is `simulate` of that
    instance with key split(key, F)[f] and the fleet's arrivals."""
    fleet = convert.fleet_from_reference(_jax_fleet(("diurnal", "bursty", "overload"), 3))
    T = 40
    pol = P.CarbonIntensityPolicy(V=0.05)
    res = P.simulate_fleet(pol, fleet, T, 11, device="cpu")
    keys = R.split(R.PRNGKey(11, device="cpu"), fleet.F)
    for f in (0, 4, fleet.F - 1):
        spec = P.NetworkSpec(*(x[f] for x in fleet.spec))
        one = P.simulate(pol, spec, P.TableCarbonSource(table=fleet.carbon[f]),
                         P.FleetArrivals(amax=fleet.arrival_amax[f]), T, keys[f], device="cpu")
        for name in ("Qe", "Qc", "emissions", "dispatched", "processed", "energy_edge",
                     "energy_cloud"):
            assert torch.equal(getattr(res, name)[f], getattr(one, name)), (f, name)


def test_fleet_summary_scalars_equal_full():
    fleet = tfs.build_fleet(["diurnal", "heterogeneous-fleet"], per_kind=3, Tc=24, device="cpu")
    pol = P.QueueLengthPolicy()
    full = P.simulate_fleet(pol, fleet, 30, 0, device="cpu")
    summ = P.simulate_fleet(pol, fleet, 30, 0, record="summary", device="cpu")
    for name in ("emissions", "cum_emissions", "dispatched", "processed", "energy_edge",
                 "energy_cloud"):
        assert torch.equal(getattr(full, name), getattr(summ, name)), name
    assert torch.equal(summ.Qe[:, 0], full.Qe[:, -1]) and summ.Qc.shape == (6, 1, 5, 5)


def test_fleet_refuses_layers_not_ported():
    """Every layer of the JAX fleet is ported: the fleet takes telemetry
    (it once refused it), a frame with a lane axis, and its other fields
    are the run without it."""
    from repro_torch.telemetry import TelemetryConfig

    fleet = tfs.build_fleet(["diurnal"], per_kind=2, Tc=8, device="cpu")
    pol = P.CarbonIntensityPolicy()
    off = P.simulate_fleet(pol, fleet, 4, device="cpu")
    on = P.simulate_fleet(pol, fleet, 4, device="cpu", telemetry=TelemetryConfig())
    assert on.telemetry.backlog.shape == (2, 4) and on.telemetry.alert_count.shape == (2, 6)
    assert torch.equal(off.Qc, on.Qc) and torch.equal(off.emissions, on.emissions)


def test_vsweep_matches_jax_and_single_v_runs():
    Vs = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2)
    T = 80
    ref = jax.jit(lambda k: J.simulate_vsweep(
        lambda V: J.CarbonIntensityPolicy(V=V), jnp.asarray(Vs, jnp.float32), jpw.paper_spec(),
        J.RandomCarbonSource(N=5), J.UniformArrivals(M=5), T, k))(jax.random.PRNGKey(0))
    got = P.simulate_vsweep(lambda V: P.CarbonIntensityPolicy(V=V), Vs, tpw.paper_spec(),
                            P.RandomCarbonSource(N=5), P.UniformArrivals(M=5), T, 0,
                            device="cpu")
    _assert_matches(got, ref)
    for i in (0, 3, 5):
        one = P.simulate(P.CarbonIntensityPolicy(V=Vs[i]), tpw.paper_spec(),
                         P.RandomCarbonSource(N=5), P.UniformArrivals(M=5), T, 0, device="cpu")
        assert torch.equal(got.Qe[i], one.Qe) and torch.equal(got.Qc[i], one.Qc)


# ------------------------------------------- carbon_scores with lanes


@pytest.mark.parametrize("F", [1, 3])
def test_carbon_scores_lane_axis_matches_vmapped_jax(F):
    rng = np.random.default_rng(F)
    M, N = 37, 11
    Qc = rng.integers(0, 50, (F, M, N)).astype(np.float32)
    pc = rng.uniform(1, 100, (F, M, N)).astype(np.float32)
    Qe = rng.integers(0, 900, (F, M)).astype(np.float32)
    pe = rng.uniform(1, 10, (F, M)).astype(np.float32)
    VCc = rng.uniform(0, 35, (F, N)).astype(np.float32)
    V_Ce = rng.uniform(0, 35, (F,)).astype(np.float32)
    args = (Qc, pc, Qe, pe, VCc, V_Ce)
    got = cs.carbon_scores_plain(*(torch.from_numpy(x) for x in args))
    ref = jax.jit(jax.vmap(jref.carbon_scores_ref))(*(jnp.asarray(x) for x in args))
    pallas = jax.vmap(lambda *a: jops.carbon_scores(*a, interpret=True))(
        *(jnp.asarray(x) for x in args))
    for g, r, p in zip(got, ref, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    # F = 1 is the [M, N] call, bit for bit
    one = cs.carbon_scores_plain(*(torch.as_tensor(x[0]) for x in args))
    for g, o in zip(got, one):
        assert torch.equal(g[0], o)


def test_poisson_arrivals_run_in_the_loop():
    rates = (5.0, 50.0, 1.0, 20.0, 300.0)
    res = P.simulate(P.CarbonIntensityPolicy(), tpw.paper_spec(), P.RandomCarbonSource(N=5),
                     P.PoissonArrivals(rates=rates, clip=100), 6, 0, device="cpu")
    assert bool(torch.isfinite(res.Qe).all())
    a = P.PoissonArrivals(rates=rates, clip=100)(2, R.PRNGKey(0, device="cpu"), "cpu")
    assert a.shape == (5,) and float(a.max()) <= 100.0 and bool((a == a.floor()).all())


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_constants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # defines constants and functions; main() does not run
    return mod


def test_fig2_reductions_pinned():
    """JAX's Fig. 2 reductions on its own streams, which chip_smoke.py
    phase 5 holds the card's run to (FIG2_JAX): the bench's setup,
    `jit(simulate)` at PRNGKey(0), T=2000."""
    cs_mod = _chip_smoke()
    key = jax.random.PRNGKey(0)

    def cum(pol):
        return float(jax.jit(lambda: J.simulate(
            pol, jpw.paper_spec(), J.RandomCarbonSource(N=5), J.UniformArrivals(M=5, amax=400),
            2000, key).cum_emissions[-1])())

    base = cum(J.QueueLengthPolicy())
    for V, want in cs_mod.FIG2_JAX.items():
        assert 100.0 * (1.0 - cum(J.CarbonIntensityPolicy(V=V)) / base) == want


def test_chip_smoke_known_answers_are_jaxs():
    """THREEFRY_KNOWN, which phase 3e holds the draw kernel to on the
    card, is jax 0.9.0's own output and the twin's."""
    cs_mod = _chip_smoke()
    for (seed, t), want in cs_mod.THREEFRY_KNOWN.items():
        k = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        Ce, Cc = J.RandomCarbonSource(N=5)(t, jax.random.PRNGKey(seed))
        jax_vals = (list(np.asarray(jax.random.bits(k, (3,))).astype(np.int64))
                    + list(np.asarray(jax.random.uniform(k, (3,))).view(np.uint32).astype(np.int64))
                    + list(np.asarray(jax.random.randint(k, (3,), 0, 401)).astype(np.int64))
                    + [int(Ce)] + [int(x) for x in np.asarray(Cc)])
        assert tuple(int(x) for x in jax_vals) == want
        tk = R.fold_in(R.PRNGKey(seed, device="cpu"), t)
        tCe, tCc = P.RandomCarbonSource(N=5)(t, R.PRNGKey(seed, device="cpu"), "cpu")
        port = (R.random_bits(tk, (3,)).tolist()
                + R.uniform(tk, (3,)).numpy().view(np.uint32).astype(np.int64).tolist()
                + R.randint(tk, (3,), 0, 401).tolist() + [int(tCe)] + [int(x) for x in tCc])
        assert tuple(port) == want


def test_chip_smoke_key_walks_are_jaxs():
    """CHAIN_KNOWN, phase 3e's known key walks (poisson's loops), is jax
    0.9.0's own output and the plain chain draw's."""
    from repro_torch.kernels import threefry as tf

    cs_mod = _chip_smoke()
    for (seed, t), want in cs_mod.CHAIN_KNOWN.items():
        k = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        vals, rng = [], k
        for _ in range(3):
            rng, sub = jax.random.split(rng)
            vals += list(np.asarray(jax.random.uniform(sub, (2,))).view(np.uint32))
        rng = k
        for _ in range(2):
            rng, a, b = jax.random.split(rng, 3)
            for sub in (a, b):
                vals += list(np.asarray(jax.random.uniform(sub, (2,))).view(np.uint32))
        assert tuple(int(x) for x in vals) == want
        tk = R.PRNGKey(seed, device="cpu")
        port = [tf.threefry_draw_plain(tk, t, 2, chain=c).reshape(-1) for c in ((3, 1), (2, 2))]
        assert tuple(int(x) for p in port for x in p.numpy().view(np.uint32)) == want
