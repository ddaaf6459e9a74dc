"""The port's WAN transfer layer against the JAX `repro.network`.

Both packages get the same inputs: graphs and specs from the same numpy
generator state (the builders are bitwise copies), one carbon table and
one [T, M] arrival table played back on each side. Integral quantities
(Qe, Qc, Qt, dispatched, delivered, processed) are bitwise equal to the
reference; emissions and energies agree to rtol 1e-6 (sums in another
order). The link step rounds where XLA:CPU contracts inside the scan
(three FMAs) and sums each route's demand in XLA:CPU's order (32-row
windows, the pad split before and after, level by level).
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
from repro.core.policies import LookaheadDPPPolicy as JLookahead  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.network.transfer import column_sum  # noqa: E402

f32 = np.float32
T = 60
SCALARS = ("emissions", "cum_emissions", "energy_edge", "energy_transfer", "energy_cloud")
COUNTS = ("dispatched", "delivered", "processed")


def _scenario(kind, M, N, seed=0, j=0):
    """The scenario from both registries at one generator state: the
    port's (spec, graph) and the JAX (spec, table, graph); the table is
    the JAX one, which both packages then play back."""
    kw = {"device": "cpu"} if kind == "multi-region-uk-wan" else {}
    tspec, ttable, amax, tgraph = tfs.NETWORK_SCENARIOS[kind](
        M, N, 96, np.random.default_rng((seed, 1, j)), **kw)
    jspec, jtable, jamax, jgraph = jfs.NETWORK_SCENARIOS[kind](
        M, N, 96, np.random.default_rng((seed, 1, j)))
    return tspec, tgraph, jspec, np.array(jtable), jgraph, amax, ttable


def _arrivals(amax, steps, seed=5):
    return np.random.default_rng(seed).integers(0, amax.astype(int) + 1,
                                                (steps, amax.shape[0])).astype(f32)


def _run_jax(pol, jspec, table, jgraph, arrivals):
    jarr = jnp.asarray(arrivals)
    return J.simulate(pol, jspec, J.TableCarbonSource(table=table), lambda t, k: jarr[t],
                      arrivals.shape[0], jax.random.PRNGKey(0), graph=jgraph)


def _run_port(pol, tspec, table, graph, arrivals, record="full", **kw):
    tab = torch.from_numpy(arrivals)
    return P.simulate(pol, tspec, P.TableCarbonSource(table=table),
                      lambda t, seed, device: tab[t], arrivals.shape[0], 0, record=record,
                      device="cpu", graph=graph, **kw)


def _assert_matches(got, ref):
    for name, q in convert.queues_numpy(got).items():
        np.testing.assert_array_equal(q, convert.queues_numpy(ref)[name], err_msg=name)
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in SCALARS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------- builders


@pytest.mark.parametrize("builder", ["star_graph", "congested_uplink_graph",
                                     "multi_region_wan_graph"])
@pytest.mark.parametrize("M,N", [(5, 5), (64, 8), (7, 2)])
def test_graph_builders_bitwise_equal_jax(builder, M, N):
    size = np.random.default_rng(1).uniform(0.5, 4, M).astype(f32)
    got = getattr(PN, builder)(M, N, np.random.default_rng(3), size=size)
    want = getattr(JN, builder)(M, N, np.random.default_rng(3), size=size)
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("dest", "region", "primary"):
        assert getattr(got, name).dtype == np.int32
    direct, jdirect = PN.direct_graph(M, N), JN.direct_graph(M, N)
    for name in jdirect._fields:
        np.testing.assert_array_equal(np.asarray(getattr(direct, name)),
                                      np.asarray(getattr(jdirect, name)), err_msg=name)
    assert (got.M, got.N, got.L) == (want.M, want.N, want.L)


@pytest.mark.parametrize("kind", ["star", "congested-uplink", "multi-region-uk-wan"])
def test_scenarios_bitwise_equal_jax(kind):
    tspec, tgraph, jspec, jtable, jgraph, amax, ttable = _scenario(kind, 64, 8, seed=2, j=1)
    for name in ("pe", "pc", "Pe", "Pc"):
        np.testing.assert_array_equal(np.asarray(getattr(tspec, name)),
                                      np.asarray(getattr(jspec, name)), err_msg=name)
    for name in jgraph._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tgraph, name)),
                                      np.asarray(getattr(jgraph, name)), err_msg=name)
    # the UK-regional table draws its noise from the device's torch
    # generator, the others are numpy and bitwise
    if kind != "multi-region-uk-wan":
        np.testing.assert_array_equal(ttable, jtable)
    else:
        assert ttable.shape == jtable.shape and ttable.dtype == np.float32
    assert set(tfs.NETWORK_SCENARIOS) == set(jfs.NETWORK_SCENARIOS)


def test_graph_conversion_and_validation():
    jg = JN.congested_uplink_graph(4, 3, np.random.default_rng(0))
    g = convert.graph_from_reference(jg, device="cpu")
    assert g.dest.dtype == torch.int64 and g.pt.dtype == torch.float32
    for name in jg._fields:
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jg, name)))
    assert g.to("cpu").pt is g.pt  # staging a staged graph copies nothing
    ok = dict(dest=[0], bw=[np.inf], pt=[[1.0]], region=[1], size=[1.0], primary=[0])
    assert torch.isinf(convert.graph_from_numpy(**ok, device="cpu").bw).all()
    with pytest.raises(ValueError, match="size"):
        PN.make_graph(**{**ok, "size": [0.0]})
    with pytest.raises(ValueError, match="bw"):
        PN.make_graph(**{**ok, "bw": [-1.0]})
    with pytest.raises(ValueError, match="dest"):
        PN.make_graph(**{**ok, "dest": [1]})
    with pytest.raises(ValueError, match="region"):
        PN.make_graph(**{**ok, "region": [2]})


# ------------------------------------------------------------ link dynamics


def _two_link_graphs(size, bw):
    M = len(size)
    kw = dict(dest=[0, 1], bw=bw, pt=np.ones((M, 2), f32), region=[1, 2], size=size,
              primary=[0, 1])
    return PN.make_graph(**kw).to("cpu"), JN.make_graph(**kw)


@pytest.mark.parametrize("M,bw", [(4, [7.0, 2.5]), (64, [300.0, 40.0]), (23, [np.inf, 9.0])])
def test_step_links_and_landing_match_jax_under_jit(M, bw):
    """A random dispatch stream through both link steps: delivered and Qt
    bitwise, prog within rtol 1e-6; landings bitwise; and, in the port,
    injected == delivered + in flight exactly."""
    rng = np.random.default_rng(M)
    g, jg = _two_link_graphs(rng.uniform(0.5, 6.0, M).astype(f32), bw)
    # the graph is an argument, as the scan carries it into the loop body:
    # closed over as a constant, XLA would rewrite prog / size as prog *
    # (1 / size), which the simulator never computes
    jstep = jax.jit(JN.step_links)
    jland = jax.jit(JN.land_in_clouds, static_argnums=2)
    ls, jls = PN.init_links(M, 2, device="cpu"), JN.init_links(M, 2)
    injected = torch.zeros((M, 2))
    delivered = torch.zeros((M, 2))
    for t in range(60):
        dt = rng.integers(0, 5, (M, 2)).astype(f32) if t < 40 else np.zeros((M, 2), f32)
        ls, dl = PN.step_links(ls, g, torch.from_numpy(dt))
        jls, jdl = jstep(jls, jg, jnp.asarray(dt))
        np.testing.assert_array_equal(dl.numpy(), np.asarray(jdl))
        np.testing.assert_array_equal(ls.Qt.numpy(), np.asarray(jls.Qt))
        np.testing.assert_allclose(ls.prog.numpy(), np.asarray(jls.prog), rtol=1e-6)
        np.testing.assert_array_equal(PN.land_in_clouds(dl, g, 2).numpy(),
                                      np.asarray(jland(jdl, jg, 2)))
        assert (dl >= 0).all() and torch.equal(dl, torch.round(dl))
        injected += torch.from_numpy(dt)
        delivered += dl
    assert torch.equal(injected, delivered + ls.Qt)
    assert (ls.prog < g.size[:, None] + 1e-5).all()


@pytest.mark.parametrize("size,bw", [(5.0, 2.0), (1.0, 1.0), (7.0, 3.0), (2.0, 8.0)])
def test_transfer_latency_is_ceil_size_over_bw(size, bw):
    g = convert.graph_from_numpy(dest=[0], bw=[bw], pt=[[1.0]], region=[1], size=[size],
                                 primary=[0], device="cpu")
    ls, dl = PN.step_links(PN.init_links(1, 1, device="cpu"), g, torch.ones((1, 1)))
    slots = 1
    while float(dl[0, 0]) == 0.0:
        ls, dl = PN.step_links(ls, g, torch.zeros((1, 1)))
        slots += 1
        assert slots < 50
    assert slots == int(np.ceil(size / bw))


def test_infinite_bandwidth_delivers_same_slot():
    g = PN.direct_graph(3, 2).to("cpu")
    dt = torch.from_numpy(np.random.default_rng(0).integers(0, 9, (3, 2)).astype(f32))
    ls, dl = PN.step_links(PN.init_links(3, 2, device="cpu"), g, dt)
    assert torch.equal(dl, dt)
    assert float(ls.Qt.abs().max()) == 0.0 and float(ls.prog.abs().max()) == 0.0


def _xla_cpu_column_sum(x):
    """numpy model of XLA:CPU's order for jit(jnp.sum(x, 0)), read from
    the compiled HLO: while more than 32 rows remain, a `reduce-window`
    of size and stride 32 whose zero pad is split lo = pad // 2 before,
    the rest after, each window summed in row order; then the last <= 32
    sums added in order."""
    x = np.asarray(x, f32)
    while x.shape[0] > 32:
        pad = -x.shape[0] % 32
        x = np.concatenate([np.zeros((pad // 2, x.shape[1]), f32), x,
                            np.zeros((pad - pad // 2, x.shape[1]), f32)])
        windows = x.reshape(-1, 32, x.shape[1])
        acc = windows[:, 0].copy()
        for i in range(1, 32):
            acc = (acc + windows[:, i]).astype(f32)
        x = acc
    acc = x[0].copy()
    for row in x[1:]:
        acc = (acc + row).astype(f32)
    return acc


@pytest.mark.parametrize("M", [1, 5, 32, 33, 40, 48, 64, 100, 256, 257, 1100])
def test_column_sum_order(M):
    """The port's column sum, the numpy model of XLA:CPU's order and
    jit(jnp.sum(x, 0)) agree bitwise at every M."""
    rng = np.random.default_rng(M)
    x = (rng.uniform(0, 1, (M, 7)) * rng.choice([1.0, 1e3, 1e-3], (M, 7))).astype(f32)
    want = _xla_cpu_column_sum(x)
    got = column_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, np.asarray(jax.jit(lambda a: jnp.sum(a, 0))(x)))


# ------------------------------------------------------------ whole runs


def _policies(name):
    if name == "aware":
        return JN.NetworkAwareDPPPolicy(V=0.1), PN.NetworkAwareDPPPolicy(V=0.1)
    if name == "aware_w":
        return (JN.NetworkAwareDPPPolicy(V=0.1, route_compute_weight=0.5),
                PN.NetworkAwareDPPPolicy(V=0.1, route_compute_weight=0.5))
    return (JN.StaticRoutePolicy(J.CarbonIntensityPolicy(V=0.1)),
            PN.StaticRoutePolicy(P.CarbonIntensityPolicy(V=0.1)))


@pytest.mark.parametrize("kind,M,N,pname", [
    ("congested-uplink", 5, 5, "aware"),
    ("congested-uplink", 64, 8, "aware"),
    ("congested-uplink", 64, 8, "blind"),
    ("congested-uplink", 16, 4, "aware_w"),
    ("multi-region-uk-wan", 5, 5, "aware"),
    ("multi-region-uk-wan", 64, 8, "aware"),
    ("star", 64, 8, "aware"),
    ("star", 5, 5, "blind"),
    # M where the column sum pads its 32-row windows (flipped deliveries
    # against JAX before it followed XLA:CPU's order)
    ("congested-uplink", 40, 5, "aware"),
    ("congested-uplink", 48, 8, "aware"),
    ("congested-uplink", 100, 16, "aware"),
    ("star", 256, 8, "aware"),
])
def test_simulate_graph_matches_jax(kind, M, N, pname):
    tspec, tgraph, jspec, table, jgraph, amax, _ = _scenario(kind, M, N)
    arrivals = _arrivals(amax, T)
    jpol, tpol = _policies(pname)
    ref = _run_jax(jpol, jspec, table, jgraph, arrivals)
    full = _run_port(tpol, tspec, table, tgraph, arrivals)
    _assert_matches(full, ref)
    assert float(ref.Qt.sum()) > 0 or kind == "multi-region-uk-wan" or pname == "blind"


def test_record_modes_agree():
    tspec, tgraph, _, table, _, amax, _ = _scenario("congested-uplink", 16, 4)
    arrivals = _arrivals(amax, T)
    pol = PN.NetworkAwareDPPPolicy(V=0.1)
    full = _run_port(pol, tspec, table, tgraph, arrivals)
    summary = _run_port(pol, tspec, table, tgraph, arrivals, record="summary")
    strided = _run_port(pol, tspec, table, tgraph, arrivals, record=10)
    for res in (summary, strided):
        for name in SCALARS + COUNTS:
            assert torch.equal(getattr(res, name), getattr(full, name)), name
    for name in ("Qe", "Qc", "Qt"):
        assert torch.equal(getattr(summary, name)[0], getattr(full, name)[-1])
        assert torch.equal(getattr(strided, name), getattr(full, name)[9::10])
    assert summary.Qt.shape == (1, 16, 8) and float(full.Qt[-1].sum()) > 0
    assert float(summary.final_backlog) == float(full.final_backlog)
    with pytest.raises(ValueError, match="record"):
        _run_port(pol, tspec, table, tgraph, arrivals, record=7)


def test_conservation_in_the_full_run():
    """dispatched == delivered + in flight, and the queues close."""
    tspec, tgraph, _, table, _, amax, _ = _scenario("congested-uplink", 16, 4)
    arrivals = _arrivals(amax, T)
    res = _run_port(PN.NetworkAwareDPPPolicy(V=0.1), tspec, table, tgraph, arrivals)
    disp, deliv = res.dispatched.double().sum(), res.delivered.double().sum()
    assert float(disp) == float(deliv + res.Qt[-1].double().sum())
    backlog = res.Qe[-1].double().sum() + res.Qc[-1].double().sum() + res.Qt[-1].double().sum()
    assert float(backlog) == float(arrivals.sum(dtype=np.float64) - res.processed.double().sum())


def test_later_layers_raise():
    """The WAN loop takes the telemetry layer, which it once refused: the
    frame's transfer_occupancy is the links' load, its backlog counts it,
    and no other field moves."""
    from repro_torch.telemetry import TelemetryConfig

    tspec, tgraph, _, table, _, amax, _ = _scenario("star", 5, 5)
    arrivals = torch.from_numpy(_arrivals(amax, 6))
    run = lambda **kw: PN.simulate_network(  # noqa: E731
        PN.NetworkAwareDPPPolicy(), tspec, tgraph, P.TableCarbonSource(table=table),
        lambda t, s, d: arrivals[t], 6, device="cpu", **kw)
    off, on = run(), run(telemetry=TelemetryConfig())
    assert off.telemetry is None
    for name in PN.NetSimResult._fields[:-2]:
        assert torch.equal(getattr(off, name), getattr(on, name)), name
    tel = on.telemetry
    assert torch.equal(tel.transfer_occupancy, on.Qt.sum(dim=(-2, -1)))
    assert torch.equal(tel.backlog, on.Qe.sum(-1) + on.Qc.sum((-2, -1)) + on.Qt.sum((-2, -1)))
    assert float(tel.conservation_residual.abs().max()) == 0.0


# ------------------------------------------------------ the direct_graph anchor


def _instance(rng, M, N):
    fields = dict(pe=rng.uniform(1, 8, M).astype(f32), pc=rng.uniform(2, 100, (M, N)).astype(f32),
                  Pe=float(rng.uniform(100, 2000)), Pc=rng.uniform(100, 5000, N).astype(f32))
    state = P.NetworkState(Qe=torch.from_numpy(rng.integers(0, 1000, M).astype(f32)),
                           Qc=torch.from_numpy(rng.integers(0, 1000, (M, N)).astype(f32)))
    return (P.NetworkSpec(**fields), state, torch.tensor(f32(rng.uniform(0, 700))),
            torch.from_numpy(rng.uniform(0, 700, N).astype(f32)))


@pytest.mark.parametrize("M,N", [(5, 5), (23, 9), (64, 16)])
def test_direct_graph_actions_equal_carbon_intensity(M, N):
    rng = np.random.default_rng(7)
    for _ in range(2):
        spec, state, Ce, Cc = _instance(rng, M, N)
        base = P.CarbonIntensityPolicy(V=0.05)(state, spec, Ce, Cc)
        net = PN.NetworkAwareDPPPolicy(V=0.05)(state, spec, Ce, Cc, graph=PN.direct_graph(M, N).to("cpu"),
                                               Qt=torch.zeros((M, N)))
        assert torch.equal(base.d, net.dt) and torch.equal(base.w, net.w)
        static = PN.StaticRoutePolicy(P.CarbonIntensityPolicy(V=0.05))(
            state, spec, Ce, Cc, graph=PN.direct_graph(M, N).to("cpu"), Qt=torch.zeros((M, N)))
        assert torch.equal(base.d, static.dt) and torch.equal(base.w, static.w)


def test_direct_graph_run_equals_link_free_simulate():
    rng = np.random.default_rng(3)
    M, N, steps = 11, 6, 40
    spec, _, _, _ = _instance(rng, M, N)
    table = P.diurnal_table(steps, N, rng)
    arrivals = rng.integers(0, 81, (steps, M)).astype(f32)
    tab = torch.from_numpy(arrivals)
    r0 = P.simulate(P.CarbonIntensityPolicy(V=0.05), spec, P.TableCarbonSource(table=table),
                    lambda t, s, d: tab[t], steps, 0, device="cpu")
    r1 = _run_port(PN.NetworkAwareDPPPolicy(V=0.05), spec, table, PN.direct_graph(M, N), arrivals)
    assert torch.equal(r0.Qe, r1.Qe) and torch.equal(r0.Qc, r1.Qc)
    assert float(r1.Qt.abs().max()) == 0.0 and float(r1.energy_transfer.abs().sum()) == 0.0
    assert torch.equal(r0.dispatched, r1.dispatched) and torch.equal(r1.dispatched, r1.delivered)
    np.testing.assert_allclose(r1.cum_emissions.numpy(), r0.cum_emissions.numpy(), rtol=1e-6)


# ------------------------------------------------------------ lookahead


@pytest.mark.parametrize("H,discount,weight", [(8, 0.98, 2.0), (4, 0.9, 1.5), (12, 0.95, 3.0),
                                               (1, 0.98, 2.0)])
def test_effective_intensities_match_jax_under_jit(H, discount, weight):
    """Under jit XLA:CPU contracts C + w*max(0, C - Cmin) into one FMA;
    the port rounds it once too."""
    rng = np.random.default_rng(H)
    jpol = JLookahead(H=H, discount=discount, defer_weight=weight)
    tpol = P.LookaheadDPPPolicy(H=H, discount=discount, defer_weight=weight)
    jfn = jax.jit(jpol.effective_intensities)
    for _ in range(20):
        fc = rng.uniform(5, 700, (H + 2, 8)).astype(f32)
        Ce, Cc = f32(rng.uniform(5, 700)), rng.uniform(5, 700, 7).astype(f32)
        got = tpol.effective_intensities(torch.tensor(Ce), torch.from_numpy(Cc), torch.from_numpy(fc))
        want = jfn(jnp.float32(Ce), jnp.asarray(Cc), jnp.asarray(fc))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    Ce_t, Cc_t = torch.tensor(Ce), torch.from_numpy(Cc)
    assert tpol.effective_intensities(Ce_t, Cc_t, None) == (Ce_t, Cc_t)
    with pytest.raises(ValueError, match="forecast covers"):
        P.LookaheadDPPPolicy(H=H + 3).effective_intensities(Ce_t, Cc_t, torch.from_numpy(fc))


def test_lookahead_h1_acts_as_carbon_intensity():
    rng = np.random.default_rng(11)
    spec, state, Ce, Cc = _instance(rng, 64, 16)
    forecast = torch.from_numpy(rng.uniform(5, 700, (4, 17)).astype(f32))
    base = P.CarbonIntensityPolicy(V=0.05)(state, spec, Ce, Cc)
    ahead = P.LookaheadDPPPolicy(V=0.05, H=1)(state, spec, Ce, Cc, forecast=forecast)
    assert torch.equal(base.d, ahead.d) and torch.equal(base.w, ahead.w)
    # a longer horizon acts as Algorithm 1 on the penalized intensities
    pol = P.LookaheadDPPPolicy(V=0.05, H=4)
    Ce_eff, Cc_eff = pol.effective_intensities(Ce, Cc, forecast)
    assert not torch.equal(Cc_eff, Cc)
    deferred = pol(state, spec, Ce, Cc, forecast=forecast)
    want = P.CarbonIntensityPolicy(V=0.05)(state, spec, Ce_eff, Cc_eff)
    assert torch.equal(deferred.d, want.d) and torch.equal(deferred.w, want.w)


# ------------------------------------------------------ the subsystem's claim


def test_route_aware_beats_transfer_blind_on_congested_uplink():
    """Test-sized acceptance property, on the tables both packages play
    back: the route-aware policy emits less than the transfer-blind
    baseline while doing comparable work, and the JAX runs agree."""
    steps = 120
    em = {"aware": 0.0, "blind": 0.0}
    proc = dict(em)
    for j in range(4):
        tspec, tgraph, jspec, table, jgraph, amax, _ = _scenario("congested-uplink", 5, 5, j=j)
        arrivals = _arrivals(amax, steps, seed=100 + j)
        for pname in ("aware", "blind"):
            jpol, tpol = _policies(pname)
            got = _run_port(tpol, tspec, table, tgraph, arrivals)
            em[pname] += float(got.cum_emissions[-1])
            proc[pname] += float(got.processed.sum())
            if j == 0:
                _assert_matches(got, _run_jax(jpol, jspec, table, jgraph, arrivals))
    assert em["aware"] < 0.95 * em["blind"], em
    assert proc["aware"] > 0.9 * proc["blind"], proc
