"""The WAN fleet against the JAX package: stacked graphs, the lane axis
of `route_scores` and of the link step, and `simulate_fleet` on a fleet
with a graph.

Both packages get the same numbers: `build_network_fleet` draws in the
JAX function's order (specs, graphs and diurnal tables bitwise), and the
multi-region-uk-wan tables, whose noise is the twin's `normal`, come
across with JAX's fleet through `convert.fleet_from_reference`. The JAX
fleet is an argument of the jitted run, so XLA does not fold the
graph's constants (ROADMAP hazard 20). Queues (Qe, Qc, Qt) and the
dispatched / delivered / processed counts are bitwise; emission and
energy series agree to rtol 1e-6.
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
from repro.kernels.ref import route_scores_ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.kernels import route_score as rs  # noqa: E402

f32 = np.float32
QUEUES = ("Qe", "Qc", "Qt")
COUNTS = ("dispatched", "delivered", "processed")
SCALARS = ("emissions", "cum_emissions", "energy_edge", "energy_transfer", "energy_cloud")


def _assert_matches(got, ref):
    for name in QUEUES + COUNTS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in SCALARS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-3, err_msg=name)


def _policies(pname, V=0.1):
    if pname == "aware":
        return JN.NetworkAwareDPPPolicy(V=V), PN.NetworkAwareDPPPolicy(V=V)
    return (JN.StaticRoutePolicy(J.CarbonIntensityPolicy(V=V)),
            PN.StaticRoutePolicy(P.CarbonIntensityPolicy(V=V)))


_FLEETS = {}


def _jax_fleet(kinds, per_kind=3, M=5, N=5, Tc=24, seed=0):
    k = (tuple(kinds), per_kind, M, N, Tc, seed)
    if k not in _FLEETS:
        _FLEETS[k] = jfs.build_network_fleet(list(kinds), per_kind=per_kind, M=M, N=N, Tc=Tc,
                                             seed=seed)
    return _FLEETS[k]


def _jax_run(jpol, jf, T, record="full", seed=0):
    # the fleet (and its graph) an argument of the jitted run (hazard 20)
    return jax.jit(lambda fl, k: J.simulate_fleet(jpol, fl, T, k, record=record))(
        jf, jax.random.PRNGKey(seed))


def _lane(res, f):
    return res._replace(**{n: getattr(res, n)[f] for n in res._fields
                           if getattr(res, n) is not None})


# ------------------------------------------------------------ graphs, fleet


def test_stack_graphs_equals_jax():
    gens = [(JN.congested_uplink_graph, PN.congested_uplink_graph),
            (JN.multi_region_wan_graph, PN.multi_region_wan_graph)]
    jg, tg = [], []
    for j, (jgen, tgen) in enumerate(gens * 2):
        jg.append(jgen(7, 4, np.random.default_rng(j)))
        tg.append(tgen(7, 4, np.random.default_rng(j)))
    jst, tst = JN.stack_graphs(jg), PN.stack_graphs(tg)
    for name in PN.LinkGraph._fields:
        np.testing.assert_array_equal(getattr(tst, name), np.asarray(getattr(jst, name)),
                                      err_msg=name)
        assert getattr(tst, name).dtype == np.asarray(getattr(jst, name)).dtype
    assert (tst.M, tst.N, tst.L) == (7, 4, 8) and tst.dest.shape == (4, 8)
    staged = tst.to("cpu")
    assert staged.pt.shape == (4, 7, 8) and staged.primary.dtype == torch.int64
    mixed = tg[:1] + [PN.star_graph(7, 4, np.random.default_rng(9))]
    jmixed = jg[:1] + [JN.star_graph(7, 4, np.random.default_rng(9))]
    for fn, graphs in ((PN.stack_graphs, mixed), (JN.stack_graphs, jmixed)):
        with pytest.raises(ValueError, match="share"):
            fn(graphs)


@pytest.mark.parametrize("kinds", [("congested-uplink",), ("star",),
                                   ("congested-uplink", "multi-region-uk-wan")])
def test_build_network_fleet_equals_jax(kinds):
    jf = _jax_fleet(kinds, per_kind=2, M=6, N=4)
    tf = tfs.build_network_fleet(list(kinds), per_kind=2, M=6, N=4, Tc=24, device="cpu")
    assert tf.F == jf.F == 2 * len(kinds)
    for name in ("pe", "pc", "Pe", "Pc"):
        np.testing.assert_array_equal(getattr(tf.spec, name), np.asarray(getattr(jf.spec, name)))
    np.testing.assert_array_equal(tf.arrival_amax, np.asarray(jf.arrival_amax))
    for name in PN.LinkGraph._fields:
        np.testing.assert_array_equal(getattr(tf.graph, name), np.asarray(getattr(jf.graph, name)),
                                      err_msg=name)
    # the diurnal tables are numpy, multi-region-uk-wan's the UK source's:
    # all bitwise
    np.testing.assert_array_equal(tf.carbon, np.asarray(jf.carbon))
    with pytest.raises(KeyError, match="unknown network scenario"):
        tfs.build_network_fleet(["no-such-kind"], per_kind=1, device="cpu")
    with pytest.raises(ValueError, match="share"):
        tfs.build_network_fleet(["star", "congested-uplink"], per_kind=1, device="cpu")


def test_fleet_from_reference_carries_the_graph():
    jf = _jax_fleet(("congested-uplink",))
    tf = convert.fleet_from_reference(jf)
    for name in PN.LinkGraph._fields:
        np.testing.assert_array_equal(getattr(tf.graph, name), np.asarray(getattr(jf.graph, name)))
    on = tf.to("cpu")
    assert on.graph.pt.shape == (3, 5, 10) and on.graph.dest.dtype == torch.int64


# ------------------------------------------------------------ route_scores lanes


def _lane_inputs(rng, F, M, L):
    return dict(
        Qt=rng.integers(0, 500, (F, M, L)).astype(f32),
        pt=rng.uniform(0, 5, (F, M, L)).astype(f32),
        Qcr=rng.integers(0, 900, (F, M, L)).astype(f32),
        extra=rng.uniform(0, 50, (F, M, L)).astype(f32),
        Qe=rng.integers(0, 900, (F, M)).astype(f32),
        pe=rng.uniform(1, 8, (F, M)).astype(f32),
        VCt=rng.uniform(0, 40, (F, L)).astype(f32),
        V_Ce=rng.uniform(0, 40, F).astype(f32),
    )


def _ref_no_extra(Qt, pt, Qcr, Qe, pe, VCt, V_Ce):
    return route_scores_ref(Qt, pt, Qcr, jnp.zeros_like(Qt), Qe, pe, VCt, V_Ce)


@pytest.mark.parametrize("with_extra", [True, False])
@pytest.mark.parametrize("F,M,L", [(1, 33, 10), (3, 40, 17), (5, 5, 10)])
def test_route_scores_lanes_match_vmapped_jax(F, M, L, with_extra):
    """The plain version on [F, M, L] against `jit(vmap(route_scores_ref))`
    (with `extra` an argument; without it, the zero folded inside the
    jit, the policy's default mode) and against F single-lane calls."""
    a = _lane_inputs(np.random.default_rng(F * 1000 + M + L), F, M, L)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    extra = t["extra"] if with_extra else None
    got = rs.route_scores_plain(t["Qt"], t["pt"], t["Qcr"], extra, t["Qe"], t["pe"], t["VCt"],
                                t["V_Ce"])
    if with_extra:
        want = jax.jit(jax.vmap(route_scores_ref))(
            *(a[k] for k in ("Qt", "pt", "Qcr", "extra", "Qe", "pe", "VCt", "V_Ce")))
    else:
        want = jax.jit(jax.vmap(_ref_no_extra))(
            *(a[k] for k in ("Qt", "pt", "Qcr", "Qe", "pe", "VCt", "V_Ce")))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for f in range(F):
        one = rs.route_scores_plain(t["Qt"][f], t["pt"][f], t["Qcr"][f],
                                    None if extra is None else extra[f], t["Qe"][f], t["pe"][f],
                                    t["VCt"][f], t["V_Ce"][f])
        for g, o in zip(got, one):
            assert torch.equal(g[f], o)


def test_route_scores_cuda_checks_lane_shapes():
    """The wrapper refuses a wrong rank or a lane-shape mismatch before
    it builds or launches anything."""
    a = {k: torch.from_numpy(v) for k, v in _lane_inputs(np.random.default_rng(0), 2, 4, 3).items()}
    with pytest.raises(ValueError, match="Qt"):
        rs.route_scores_cuda(a["Qt"][None], a["pt"], a["Qcr"], None, a["Qe"], a["pe"], a["VCt"],
                             a["V_Ce"])
    with pytest.raises(ValueError, match="pt"):
        rs.route_scores_cuda(a["Qt"], a["pt"][0], a["Qcr"], None, a["Qe"], a["pe"], a["VCt"],
                             a["V_Ce"])


# ------------------------------------------------------------ the fleet


@pytest.mark.parametrize("kind,pname", [("star", "aware"), ("star", "blind"),
                                        ("congested-uplink", "aware"),
                                        ("congested-uplink", "blind"),
                                        ("multi-region-uk-wan", "aware"),
                                        ("multi-region-uk-wan", "blind")])
def test_wan_fleet_matches_jax(kind, pname):
    """Three lanes of each topology against JAX's vmapped simulate_fleet
    (multi-region-uk-wan through `convert`, JAX's tables)."""
    jf = _jax_fleet((kind,))
    jpol, tpol = _policies(pname)
    T = 40
    ref = _jax_run(jpol, jf, T)
    got = P.simulate_fleet(tpol, convert.fleet_from_reference(jf), T, 0, device="cpu")
    assert isinstance(got, PN.NetSimResult) and got.Qt.shape == (3, T, 5, jf.graph.L)
    _assert_matches(got, ref)
    assert pname == "blind" or float(got.Qt.sum()) > 0


@pytest.mark.parametrize("M,N", [(33, 4), (40, 5), (100, 8)])
def test_wan_fleet_column_sum_windows_match_jax(M, N):
    """M past one 32-row window, where each lane's per-route column sum
    pads and sums in XLA:CPU's windows, inside JAX's vmapped scan beside
    the link step's three FMAs."""
    jf = _jax_fleet(("congested-uplink",), per_kind=2, M=M, N=N)
    jpol, tpol = _policies("aware")
    T = 30
    ref = _jax_run(jpol, jf, T, record="summary")
    got = P.simulate_fleet(tpol, convert.fleet_from_reference(jf), T, 0, record="summary",
                           device="cpu")
    _assert_matches(got, ref)
    assert float(got.Qt.sum()) > 0


@pytest.mark.parametrize("record", ["summary", 8])
def test_wan_fleet_record_modes_match_jax(record):
    jf = _jax_fleet(("congested-uplink", "multi-region-uk-wan"), per_kind=2)
    jpol, tpol = _policies("aware")
    T = 32
    ref = _jax_run(jpol, jf, T, record=record)
    tf = convert.fleet_from_reference(jf)
    got = P.simulate_fleet(tpol, tf, T, 0, record=record, device="cpu")
    _assert_matches(got, ref)
    full = P.simulate_fleet(tpol, tf, T, 0, device="cpu")
    stride = T if record == "summary" else record
    for name in QUEUES:
        assert torch.equal(getattr(got, name), getattr(full, name)[:, stride - 1::stride])


def test_wan_fleet_lane_equals_its_instance_alone():
    """Lane f is `simulate(graph=)` of its instance with key split(key,
    F)[f] and the fleet's arrivals, on the CPU as on the card."""
    from repro_torch import random as R

    tf = tfs.build_network_fleet(["congested-uplink"], per_kind=3, Tc=24, device="cpu")
    pol = PN.NetworkAwareDPPPolicy(V=0.1)
    T = 30
    res = P.simulate_fleet(pol, tf, T, 4, device="cpu")
    keys = R.split(R.PRNGKey(4, device="cpu"), tf.F)
    for f in range(tf.F):
        spec = P.NetworkSpec(*(x[f] for x in tf.spec))
        graph = PN.LinkGraph(*(x[f] for x in tf.graph))
        one = P.simulate(pol, spec, P.TableCarbonSource(table=tf.carbon[f]),
                         P.FleetArrivals(amax=tf.arrival_amax[f]), T, keys[f], device="cpu",
                         graph=graph)
        lane = _lane(res, f)
        for name in QUEUES + COUNTS + ("emissions",):
            assert torch.equal(getattr(lane, name), getattr(one, name)), (f, name)


def test_direct_graph_fleet_equals_link_free_fleet():
    """On `direct_graph` lanes the WAN fleet is bitwise the link-free
    fleet under CarbonIntensity (the subsystem's anchor, on lanes)."""
    fleet = tfs.build_fleet(["diurnal", "bursty"], per_kind=2, Tc=24, device="cpu")
    g = PN.direct_graph(5, 5)
    wan = fleet._replace(graph=PN.stack_graphs([g] * fleet.F))
    T = 30
    base = P.simulate_fleet(P.CarbonIntensityPolicy(V=0.05), fleet, T, 0, device="cpu")
    for pol in (PN.NetworkAwareDPPPolicy(V=0.05),
                PN.StaticRoutePolicy(P.CarbonIntensityPolicy(V=0.05))):
        net = P.simulate_fleet(pol, wan, T, 0, device="cpu")
        for name in ("Qe", "Qc", "dispatched", "processed"):
            assert torch.equal(getattr(net, name), getattr(base, name)), name
        assert float(net.Qt.abs().max()) == 0.0 and torch.equal(net.dispatched, net.delivered)
        np.testing.assert_allclose(net.cum_emissions.numpy(), base.cum_emissions.numpy(),
                                   rtol=1e-6)


def test_wan_fleet_conserves_tasks_per_lane():
    """Per lane: dispatched == delivered + in flight, and the backlog is
    arrivals less processed (arrivals read back from Qe's step)."""
    tf = tfs.build_network_fleet(["congested-uplink", "multi-region-uk-wan"], per_kind=2, Tc=24,
                                 device="cpu")
    T = 40
    res = P.simulate_fleet(PN.NetworkAwareDPPPolicy(V=0.1), tf, T, 0, device="cpu")
    disp, deliv = res.dispatched.double().sum(-1), res.delivered.double().sum(-1)
    assert torch.equal(disp, deliv + res.Qt[:, -1].double().sum((-2, -1)))
    # Qe(t+1) = max(Qe(t) - sum d, 0) + a(t), with every dispatch <= Qe
    Qe = torch.cat([torch.zeros_like(res.Qe[:, :1]), res.Qe], dim=1).double()
    arrivals = (Qe[:, 1:].sum(-1) - Qe[:, :-1].sum(-1) + res.dispatched.double()).sum(-1)
    backlog = (res.Qe[:, -1].double().sum(-1) + res.Qc[:, -1].double().sum((-2, -1))
               + res.Qt[:, -1].double().sum((-2, -1)))
    assert torch.equal(backlog, arrivals - res.processed.double().sum(-1))
    assert bool((res.Qt >= 0).all()) and bool((res.Qc >= 0).all())


# ------------------------------------------------------------ chip_smoke's anchor


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_wan_fleet_anchor_pinned():
    """WAN_JAX, which chip_smoke.py phase 4d holds the card's W1 runs to,
    is jax 0.9.0's own reduction: `bench_network_routing`'s rows
    (build_network_fleet([kind], per_kind=64, Tc=96, seed=0), V=0.1,
    T=192, record=T//8, PRNGKey(0)) with the fleet an argument of the
    jitted run."""
    cs_mod = _chip_smoke()
    T = cs_mod.T_W1
    for kind, want in cs_mod.WAN_JAX.items():
        jf = jfs.build_network_fleet([kind], per_kind=cs_mod.W1_PER_KIND, Tc=96, seed=0)
        cum = {}
        for pname in ("aware", "blind"):
            jpol, _ = _policies(pname, V=cs_mod.V_WAN)
            cum[pname] = np.asarray(_jax_run(jpol, jf, T, record=T // 8).cum_emissions[:, -1])
        assert float(100.0 * (1.0 - (cum["aware"] / cum["blind"])).mean()) == want
