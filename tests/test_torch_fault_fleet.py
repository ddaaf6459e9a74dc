"""Fault lanes in the port's fleet (`simulate_fleet` on a fleet with a
fault axis, plain and WAN) against the JAX package's vmapped programs,
and chip_smoke.py's FAULT_JAX anchor.

Each registered scenario (regional-blackout and telemetry-brownout on a
plain fleet, flappy-uplink on a congested-uplink WAN fleet) runs under
the bench's three policies against JAX's `simulate_fleet` with the fleet
an argument of the jitted run (ROADMAP hazard 24): queues, the retry
pool and every count bitwise, emissions rtol 1e-6. A zero-fault fleet is
bitwise the plain fleet, every lane is bitwise its instance run alone,
and the whole fleet's fault uniforms are one draw a slot.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")

import repro.core as J  # noqa: E402
import repro.faults as JF  # noqa: E402
import repro.network as JN  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
import repro_torch.network as PN  # noqa: E402
from repro.configs import fleet_scenarios as jfs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

T = 24
INTS = ("Qe", "Qc", "retry", "arrived", "dispatched", "processed", "failed", "requeued", "stale",
        "clouds_down", "backlog")
FLOATS = ("emissions", "cum_emissions", "energy_edge", "energy_cloud", "wasted")
NET_INTS = INTS + ("Qt", "delivered", "links_down")
NET_FLOATS = FLOATS + ("energy_transfer",)


def _policies(pname, wan, V=0.05):
    if wan:
        aware = (JN.NetworkAwareDPPPolicy(V=V), PN.NetworkAwareDPPPolicy(V=V))
        return {"qlen": (JN.StaticRoutePolicy(J.QueueLengthPolicy()),
                         PN.StaticRoutePolicy(P.QueueLengthPolicy())),
                "carbon": aware,
                "guard": (JF.StalenessGuardPolicy(inner=aware[0]),
                          PF.StalenessGuardPolicy(inner=aware[1]))}[pname]
    ci = (J.CarbonIntensityPolicy(V=V), P.CarbonIntensityPolicy(V=V))
    return {"qlen": (J.QueueLengthPolicy(), P.QueueLengthPolicy()), "carbon": ci,
            "guard": (JF.StalenessGuardPolicy(inner=ci[0]),
                      PF.StalenessGuardPolicy(inner=ci[1]))}[pname]


def _fleets(wan, per_kind=2, M=6, N=4):
    if wan:
        return (jfs.build_network_fleet(["congested-uplink"], per_kind=per_kind, M=M, N=N, Tc=24,
                                        seed=0),
                tfs.build_network_fleet(["congested-uplink"], per_kind=per_kind, M=M, N=N, Tc=24,
                                        seed=0, device="cpu"))
    kinds = ["diurnal-slack", "overload"]
    return (jfs.build_fleet(kinds, per_kind=per_kind, M=M, N=N, Tc=24, seed=0),
            tfs.build_fleet(kinds, per_kind=per_kind, M=M, N=N, Tc=24, seed=0, device="cpu"))


def _jax_run(jpol, jf, T=T, record="full", seed=0):
    return jax.jit(lambda fl, k: J.simulate_fleet(jpol, fl, T, k, record=record))(
        jf, jax.random.PRNGKey(seed))


def _assert_matches(got, ref, ints, floats):
    for name in ints:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in floats:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("pname", ["qlen", "carbon", "guard"])
@pytest.mark.parametrize("scen", ["regional-blackout", "telemetry-brownout", "flappy-uplink"])
def test_fault_fleet_matches_jax(scen, pname):
    wan = scen == "flappy-uplink"
    jfl, tfl = _fleets(wan)
    jpol, tpol = _policies(pname, wan)
    ref = _jax_run(jpol, jfs.with_faults(jfl, scen, seed=1))
    got = P.simulate_fleet(tpol, tfs.with_faults(tfl, scen, seed=1), T, 0, device="cpu")
    assert isinstance(got, PF.NetFaultSimResult if wan else PF.FaultSimResult)
    _assert_matches(got, ref, NET_INTS if wan else INTS, NET_FLOATS if wan else FLOATS)


def test_fault_fleet_from_reference_matches_jax():
    """The JAX fleet itself carried over (`convert.fleet_from_reference`
    takes its fault axis), summary recording."""
    jfl, _ = _fleets(False)
    jff = jfs.with_faults(jfl, "regional-blackout", seed=2)
    jpol, tpol = _policies("guard", False)
    ref = _jax_run(jpol, jff, record="summary")
    got = P.simulate_fleet(tpol, convert.fleet_from_reference(jff), T, 0, record="summary",
                           device="cpu")
    _assert_matches(got, ref, INTS, FLOATS)
    assert got.Qc.shape == (4, 1, 6, 4)


@pytest.mark.parametrize("wan", [False, True])
def test_zero_fault_fleet_is_the_plain_fleet(wan):
    """Every field the fault-free fleet has is bitwise the zero-fault
    fleet's, for both score routes (carbon_scores, route_scores)."""
    _, tfl = _fleets(wan)
    N, L = tfl.spec.Pc.shape[1], None if tfl.graph is None else tfl.graph.bw.shape[-1]
    zero = tfl._replace(faults=PF.stack_faults([PF.no_faults(N, L, device="cpu")] * tfl.F))
    pol = PN.NetworkAwareDPPPolicy(V=0.05) if wan else P.CarbonIntensityPolicy(V=0.05)
    r0 = P.simulate_fleet(pol, tfl, T, 3, device="cpu")
    r1 = P.simulate_fleet(pol, zero, T, 3, device="cpu")
    for name in type(r0)._fields:
        a, b = getattr(r0, name), getattr(r1, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    r2 = P.simulate_fleet(PF.StalenessGuardPolicy(pol), zero, T, 3, device="cpu")
    for name in type(r1)._fields:
        a, b = getattr(r1, name), getattr(r2, name)
        assert (a is None and b is None) or torch.equal(a, b), name


@pytest.mark.parametrize("scen", ["telemetry-brownout", "flappy-uplink"])
def test_lanes_equal_single_runs(scen):
    """Lane f of a faulted fleet is bitwise its instance run alone with
    key split(key, F)[f] and its own FaultParams."""
    from repro_torch import random as R

    wan = scen == "flappy-uplink"
    _, tfl = _fleets(wan)
    tff = tfs.with_faults(tfl, scen, seed=4)
    _, tpol = _policies("guard", wan)
    fleet = P.simulate_fleet(tpol, tff, T, 7, device="cpu")
    keys = R.split(R.PRNGKey(7, device="cpu"), tff.F)
    for f in (0, tff.F - 1):
        spec = P.NetworkSpec(*(torch.as_tensor(x[f]) for x in tff.spec))
        fp = PF.FaultParams(*(None if x is None else x[f] for x in tff.faults))
        kw = {}
        if wan:
            kw["graph"] = PN.LinkGraph(*(np.asarray(x)[f] for x in tff.graph))
        one = P.simulate(tpol, spec, P.TableCarbonSource(table=tff.carbon[f]),
                         P.FleetArrivals(amax=tff.arrival_amax[f]), T, keys[f], device="cpu",
                         faults=fp, **kw)
        for name in type(one)._fields:
            a = getattr(one, name)
            if a is not None:
                assert torch.equal(getattr(fleet, name)[f], a), (name, f)


def test_one_fault_draw_a_slot():
    """The fleet's fault uniforms are one threefry_draw call a slot
    (plus the arrivals' one draw for the run's block of slots), whatever
    F."""
    _, tfl = _fleets(False, per_kind=3)
    tff = tfs.with_faults(tfl, "regional-blackout")
    calls = []
    real = ops.threefry_draw

    def counting(*a, **kw):
        calls.append(kw.get("paths") is not None)
        return real(*a, **kw)

    ops.threefry_draw = counting
    try:
        P.simulate_fleet(P.QueueLengthPolicy(), tff, 5, 0, device="cpu")
    finally:
        ops.threefry_draw = real
    assert sum(calls) == 5 and len(calls) == 6


def test_simulate_fleet_and_network_take_faults():
    """The fault axis is no longer refused: simulate_fleet runs it, and
    simulate_network(faults=) returns the fault ledger."""
    _, tfl = _fleets(False)
    res = P.simulate_fleet(P.CarbonIntensityPolicy(), tfs.with_faults(tfl, "regional-blackout"),
                           4, device="cpu")
    assert res.retry.shape == (4, 4, 6, 4) and res.backlog.shape == (4, 4)
    g = PN.star_graph(5, 5, np.random.default_rng(1))
    spec = tfs._base(5, 5)
    net = PN.simulate_network(PN.NetworkAwareDPPPolicy(), spec, g, P.RandomCarbonSource(N=5),
                              P.UniformArrivals(M=5), 4, device="cpu",
                              faults=PF.make_faults(5, g.L, device="cpu", task_p_fail=0.5))
    assert isinstance(net, PF.NetFaultSimResult) and net.links_down.shape == (4,)
    assert bool(torch.isfinite(net.emissions).all())


# ------------------------------------------------------------ chip_smoke's anchor


def test_fault_anchors_pinned():
    """FAULT_JAX, which chip_smoke.py phase 4f holds the card to, is jax
    0.9.0's `bench_fault_robustness` (F16 per fleet, T=192, V=0.05,
    record="summary", PRNGKey(0), with_faults(..., seed=0)) with the
    fleet an argument of the jitted run: each row's recovery, emission
    reduction against qlen and completed %. The guard's zero-fault run
    is its inner policy's (bitwise, asserted above), so it is run once."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    key = jax.random.PRNGKey(0)
    fleets = {False: jfs.build_fleet(["diurnal-slack"], per_kind=cs.FAULT_PER_KIND, Tc=96, seed=0),
              True: jfs.build_network_fleet(["congested-uplink"], per_kind=cs.FAULT_PER_KIND,
                                            Tc=96, seed=0)}

    def run(pol, flt):
        return jax.jit(lambda fl, k: J.simulate_fleet(pol, fl, cs.T_FAULT, k, record="summary"))(
            flt, key)

    zero_runs = {}
    for scen, rows in cs.FAULT_JAX.items():
        wan = scen == "flappy-uplink"
        flt = fleets[wan]
        N, L = flt.spec.Pc.shape[1], None if flt.graph is None else flt.graph.bw.shape[-1]
        zero = flt._replace(faults=JF.stack_faults([JF.no_faults(N, L)] * flt.F))
        got = {}
        for pname in rows:
            jpol = _policies(pname, wan, V=cs.V_FAULT)[0]
            r = run(jpol, jfs.with_faults(flt, scen, seed=0))
            zkey = (wan, "carbon" if pname == "guard" else pname)
            if zkey not in zero_runs:
                zero_runs[zkey] = run(_policies(zkey[1], wan, V=cs.V_FAULT)[0], zero)
            got[pname] = cs.fault_row_stats(r, zero_runs[zkey])
        for pname, want in rows.items():
            rec, em, comp = got[pname]
            assert (rec, 100.0 * (1.0 - em / got["qlen"][1]), comp) == want, (scen, pname)
