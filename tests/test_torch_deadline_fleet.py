"""Deadline lanes in the port's fleet (`simulate_fleet` on a fleet with a
deadline axis: plain, WAN and faulted) against the JAX package's vmapped
programs, and chip_smoke.py's DEADLINE_JAX anchor.

`with_deadlines` draws every scenario's per-lane parameters bitwise
JAX's. Each scenario runs under the layer's policies against JAX's
`simulate_fleet` with the fleet an argument of the jitted run (ROADMAP
hazard 24): queues, the rings `Qd` and the missed, shed and admitted
counts bitwise, emissions rtol 1e-6. A no_deadlines fleet is bitwise the
plain fleet, and every lane is bitwise its instance run alone.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")

import repro.core as J  # noqa: E402
import repro.deadlines as JD  # noqa: E402
import repro.faults as JF  # noqa: E402
import repro.forecast as JFc  # noqa: E402
import repro.network as JN  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.deadlines as PD  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
import repro_torch.forecast as PFc  # noqa: E402
import repro_torch.network as PN  # noqa: E402
from repro.configs import fleet_scenarios as jfs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402

T = 24
SCENARIOS = ("tight-uniform", "mixed-slo", "shed-overload", "generous-slack")
INTS = ("Qe", "Qc", "dispatched", "processed")
LEDGER = ("missed", "shed", "admitted", "Qd")


def _fleets(kinds=("diurnal-slack", "overload"), per_kind=2, M=6, N=4):
    return (jfs.build_fleet(list(kinds), per_kind=per_kind, M=M, N=N, Tc=24, seed=0),
            tfs.build_fleet(list(kinds), per_kind=per_kind, M=M, N=N, Tc=24, seed=0, device="cpu"))


def _jax_run(jpol, jf, T=T, record="full", fc=None):
    return jax.jit(lambda fl, k: J.simulate_fleet(jpol, fl, T, k, record=record, forecaster=fc))(
        jf, jax.random.PRNGKey(0))


def _assert_matches(got, ref, ints=INTS, floats=("emissions", "cum_emissions", "energy_edge",
                                                  "energy_cloud")):
    for name in ints:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in LEDGER:
        np.testing.assert_array_equal(getattr(got.deadlines, name).numpy(),
                                      np.asarray(getattr(ref.deadlines, name)), err_msg=name)
    for name in floats:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("kind", SCENARIOS)
def test_deadline_scenarios_equal_jax(kind):
    """Every registered scenario's per-lane parameters, bit for bit (lane
    j from default_rng((seed, 11, j)))."""
    jfl, tfl = _fleets()
    jd, td = jfs.with_deadlines(jfl, kind, seed=5), tfs.with_deadlines(tfl, kind, seed=5)
    for name in PD.DeadlineParams._fields:
        np.testing.assert_array_equal(getattr(td.deadlines, name).numpy(),
                                      np.asarray(getattr(jd.deadlines, name)), err_msg=name)
    assert td.deadlines.deadline.shape == (4, 6)
    assert td.deadlines.D == (64 if kind == "generous-slack" else 32)
    assert set(tfs.DEADLINE_SCENARIOS) == set(jfs.DEADLINE_SCENARIOS)
    with pytest.raises(KeyError, match="unknown deadline scenario"):
        tfs.with_deadlines(tfl, "no-such-slo")


_POLICIES = {
    "carbon": (lambda: J.CarbonIntensityPolicy(V=0.2), lambda: P.CarbonIntensityPolicy(V=0.2)),
    "slack": (lambda: JD.SlackThresholdPolicy(V=0.2), lambda: PD.SlackThresholdPolicy(V=0.2)),
    "edd": (JD.EDDPolicy, PD.EDDPolicy),
}


@pytest.mark.parametrize("pname", list(_POLICIES))
@pytest.mark.parametrize("kind", SCENARIOS)
def test_deadline_fleet_matches_jax(kind, pname):
    jfl, tfl = _fleets()
    jp, tp = (f() for f in _POLICIES[pname])
    ref = _jax_run(jp, jfs.with_deadlines(jfl, kind, seed=1))
    got = P.simulate_fleet(tp, tfs.with_deadlines(tfl, kind, seed=1), T, 0, device="cpu")
    _assert_matches(got, ref)


@pytest.mark.parametrize("pname", ["slack", "wait"])
def test_forecast_deadline_fleet_matches_jax(pname):
    """The bench's lookahead deadline policies on lanes, fed a clairvoyant
    forecaster, summary records."""
    jfl, tfl = _fleets(("diurnal-slack",), per_kind=3)
    jp, tp = {"slack": (JD.SlackThresholdPolicy(V=0.2, H=4), PD.SlackThresholdPolicy(V=0.2, H=4)),
              "wait": (JD.WaitAwhilePolicy(V=0.2, H=4, J=2),
                       PD.WaitAwhilePolicy(V=0.2, H=4, J=2))}[pname]
    ref = _jax_run(jp, jfs.with_deadlines(jfl, "tight-uniform", seed=2), record="summary",
                   fc=JFc.ClairvoyantTableForecaster(H=4))
    got = P.simulate_fleet(tp, tfs.with_deadlines(tfl, "tight-uniform", seed=2), T, 0,
                           record="summary", device="cpu",
                           forecaster=PFc.ClairvoyantTableForecaster(H=4))
    _assert_matches(got, ref)
    assert got.deadlines.Qd.shape == (3, 1, 6, 32)


def test_wan_deadline_fleet_matches_jax():
    jfl = jfs.build_network_fleet(["congested-uplink"], per_kind=2, M=6, N=4, Tc=24, seed=0)
    tfl = tfs.build_network_fleet(["congested-uplink"], per_kind=2, M=6, N=4, Tc=24, seed=0,
                                  device="cpu")
    ref = _jax_run(JN.NetworkAwareDPPPolicy(V=0.05), jfs.with_deadlines(jfl, "shed-overload"))
    got = P.simulate_fleet(PN.NetworkAwareDPPPolicy(V=0.05), tfs.with_deadlines(
        tfl, "shed-overload"), T, 0, device="cpu")
    assert isinstance(got, PN.NetSimResult)
    _assert_matches(got, ref, ints=INTS + ("Qt", "delivered"))


@pytest.mark.parametrize("wan", [False, True])
def test_faulted_deadline_fleet_matches_jax(wan):
    """The bench's blackout row shape: the guard over SlackThreshold on a
    fleet with fault and deadline lanes (and a WAN fleet's flaps)."""
    if wan:
        jfl = jfs.build_network_fleet(["congested-uplink"], per_kind=2, M=6, N=4, Tc=24, seed=0)
        tfl = tfs.build_network_fleet(["congested-uplink"], per_kind=2, M=6, N=4, Tc=24, seed=0,
                                      device="cpu")
        scen = "flappy-uplink"
        jinner, tinner = JN.NetworkAwareDPPPolicy(V=0.05), PN.NetworkAwareDPPPolicy(V=0.05)
    else:
        jfl, tfl = _fleets(("overload",))
        scen = "regional-blackout"
        jinner, tinner = JD.SlackThresholdPolicy(V=0.2), PD.SlackThresholdPolicy(V=0.2)
    jff = jfs.with_deadlines(jfs.with_faults(jfl, scen, seed=0), "shed-overload", seed=0)
    tff = tfs.with_deadlines(tfs.with_faults(tfl, scen, seed=0), "shed-overload", seed=0)
    ref = _jax_run(JF.StalenessGuardPolicy(inner=jinner), jff, T=48)
    got = P.simulate_fleet(PF.StalenessGuardPolicy(inner=tinner), tff, 48, 0, device="cpu")
    assert isinstance(got, PF.NetFaultSimResult if wan else PF.FaultSimResult)
    ints = INTS + ("retry", "arrived", "failed", "requeued", "stale", "clouds_down", "backlog")
    _assert_matches(got, ref, ints=ints + (("Qt", "delivered", "links_down") if wan else ()))
    assert float(got.deadlines.shed.sum()) > 0


def test_deadline_fleet_from_reference_matches_jax():
    """The JAX fleet itself carried over: `convert.fleet_from_reference`
    takes its deadline axis."""
    jfl, _ = _fleets()
    jfd = jfs.with_deadlines(jfl, "mixed-slo", seed=3)
    ref = _jax_run(JD.SlackThresholdPolicy(V=0.2), jfd, record="summary")
    got = P.simulate_fleet(PD.SlackThresholdPolicy(V=0.2), convert.fleet_from_reference(jfd), T,
                           0, record="summary", device="cpu")
    _assert_matches(got, ref)


@pytest.mark.parametrize("pname", ["carbon", "slack"])
def test_no_deadline_fleet_is_the_plain_fleet(pname):
    """Every field of the fleet without the layer is bitwise the
    no_deadlines fleet's; SlackThreshold there is LookaheadDPP (its parent
    without a forecast: CarbonIntensity) bitwise."""
    _, tfl = _fleets()
    nd = tfl._replace(deadlines=PD.stack_deadlines([PD.no_deadlines(6, device="cpu")] * tfl.F))
    r0 = P.simulate_fleet(P.LookaheadDPPPolicy(V=0.2), tfl, T, 3, device="cpu")
    pol = P.CarbonIntensityPolicy(V=0.2) if pname == "carbon" else PD.SlackThresholdPolicy(V=0.2)
    r1 = P.simulate_fleet(pol, nd, T, 3, device="cpu")
    for name in type(r0)._fields:
        a = getattr(r0, name)
        assert a is None or torch.equal(a, getattr(r1, name)), name
    assert float(r1.deadlines.missed.sum()) == float(r1.deadlines.shed.sum()) == 0.0


@pytest.mark.parametrize("kind", ["shed-overload", "mixed-slo"])
def test_lanes_equal_single_runs(kind):
    """Lane f of a deadline fleet is bitwise its instance run alone with
    key split(key, F)[f] and its own DeadlineParams."""
    _, tfl = _fleets()
    tfd = tfs.with_deadlines(tfl, kind, seed=4)
    pol = PD.SlackThresholdPolicy(V=0.2)
    fleet = P.simulate_fleet(pol, tfd, T, 7, device="cpu")
    keys = R.split(R.PRNGKey(7, device="cpu"), tfd.F)
    for f in (0, tfd.F - 1):
        spec = P.NetworkSpec(*(torch.as_tensor(x[f]) for x in tfd.spec))
        one = P.simulate(pol, spec, P.TableCarbonSource(table=tfd.carbon[f]),
                         P.FleetArrivals(amax=tfd.arrival_amax[f]), T, keys[f], device="cpu",
                         deadlines=PD.DeadlineParams(*(x[f] for x in tfd.deadlines)))
        for name in INTS + ("emissions",):
            assert torch.equal(getattr(fleet, name)[f], getattr(one, name)), (name, f)
        for name in LEDGER:
            assert torch.equal(getattr(fleet.deadlines, name)[f],
                               getattr(one.deadlines, name)), (name, f)


# ------------------------------------------------------------ chip_smoke's anchor


def test_deadline_anchors_pinned():
    """DEADLINE_JAX, which chip_smoke.py phase 4g holds the card to, is jax
    0.9.0's `bench_deadline_pareto` (F16 per fleet, T=192, V=0.2, H=16,
    record="summary", PRNGKey(0), with_deadlines / with_faults(...,
    seed=0)) with the fleet an argument of the jitted run: every row's
    counts and the reductions and waiting, equal to the pasted values."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    key = jax.random.PRNGKey(0)
    base = jfs.build_fleet(["diurnal-slack"], per_kind=cs.DL_PER_KIND, Tc=96, seed=0)
    over = jfs.build_fleet(["overload"], per_kind=cs.DL_PER_KIND, Tc=96, seed=0)

    def run(pol, fleet, fc):
        return jax.jit(lambda fl, k: J.simulate_fleet(pol, fl, cs.T_DL, k, forecaster=fc,
                                                      record="summary"))(fleet, key)

    rows, _ = cs.deadline_rows(dict(core=J, deadlines=JD, faults=JF, forecast=JFc,
                                    fleet_scenarios=jfs), base, over, run)
    assert rows == cs.DEADLINE_JAX
