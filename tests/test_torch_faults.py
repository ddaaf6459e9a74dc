"""The port's fault layer (`repro_torch.faults`) against the JAX
package's `repro.faults`, on single runs.

Every anchor of `tests/test_faults.py` has its twin here: the zero-fault
runs (plain and WAN, both score routes: carbon_scores and route_scores)
and the guard under no faults are bitwise the fault-free and inner runs;
a blackout masks service; a dead feed freezes the view; a hard flap on
infinite links gives no NaN; total failure conserves tasks; retries come
back after recovery; the guard's V decay, outage-aware dispatch and
construction errors.

Against JAX (its run under `jit`, inside the simulator's scan) every
scenario's integral fields (queues, retry pool, failed, requeued, stale,
clouds and links down, backlog, arrived, dispatched, processed) are
bitwise and emissions, energies and `wasted` within rtol 1e-6. The
roundings XLA gives inside the scan are held by crafted cases: the guard's
decay fma(-stale, 1/s0, 1) at stale_after 6, 7 and 10, and the failure
draw's floor(fma(w, p, u)) at a floor that the unfused form flips. The
release rate's exp2 is in `tests/test_torch_numerics_xla.py`. The slot's
fault uniforms (`threefry_draw(paths=...)`'s plain version) are JAX's
key walk bitwise, and conservation is a hypothesis property over bounds
exact in float32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.core as J  # noqa: E402
import repro.faults as JF  # noqa: E402
import repro.network as JN  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
import repro_torch.network as PN  # noqa: E402
from repro.configs import fleet_scenarios as jfs  # noqa: E402
from repro.core.queueing import Action as JAction  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.core.queueing import Action as PAction  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.numerics import fma_f32  # noqa: E402

T = 32
M, N = 4, 3
f32 = np.float32
INTS = ("Qe", "Qc", "retry", "arrived", "dispatched", "processed", "failed", "requeued", "stale",
        "clouds_down", "backlog")
FLOATS = ("emissions", "cum_emissions", "energy_edge", "energy_cloud", "wasted")


def _setup(L=None):
    return (tfs._base(M, N), P.RandomCarbonSource(N=N), P.UniformArrivals(M=M), 42)


def _faults(**kw):
    return PF.make_faults(N, device="cpu", **kw)


def _run(pol, T=T, **kw):
    spec, src, arr, key = _setup()
    return P.simulate(pol, spec, src, arr, T, key, device="cpu", **kw)


def _same_shared_fields(ref, faulted):
    for name in type(ref)._fields:
        a, b = getattr(ref, name), getattr(faulted, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def _assert_matches(got, ref, ints=INTS, floats=FLOATS):
    for name in ints:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in floats:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-3, err_msg=name)


# ---------------------------------------------------- zero-fault anchor


@pytest.mark.parametrize("pname", ["carbon", "queue"])
def test_zero_fault_bitwise_parity_plain(pname):
    pol = P.CarbonIntensityPolicy(V=0.05) if pname == "carbon" else P.QueueLengthPolicy()
    r0 = _run(pol)
    r1 = _run(pol, faults=PF.no_faults(N, device="cpu"))
    _same_shared_fields(r0, r1)
    assert float(r1.failed.sum()) == float(r1.stale.sum()) == float(r1.wasted.sum()) == 0.0


@pytest.mark.parametrize("pname", ["aware", "static"])
def test_zero_fault_bitwise_parity_network(pname):
    g = PN.star_graph(M, N, np.random.default_rng(7))
    pol = (PN.NetworkAwareDPPPolicy(V=0.05) if pname == "aware"
           else PN.StaticRoutePolicy(P.CarbonIntensityPolicy(V=0.05)))
    r0 = _run(pol, graph=g)
    r1 = _run(pol, graph=g, faults=PF.no_faults(N, g.L, device="cpu"))
    _same_shared_fields(r0, r1)
    assert float(r1.links_down.sum()) == 0.0


@pytest.mark.parametrize("pname", ["carbon", "lookahead", "aware"])
def test_zero_fault_guard_is_inner_bitwise(pname):
    """Fresh signal, no outage: V * 1.0 and Qc + 0.0 are exact, so
    guard(inner) == inner."""
    inner = {"carbon": P.CarbonIntensityPolicy(V=0.05),
             "lookahead": P.LookaheadDPPPolicy(V=0.05, H=1),
             "aware": PN.NetworkAwareDPPPolicy(V=0.05)}[pname]
    kw = {}
    L = None
    if pname == "aware":
        kw["graph"] = PN.star_graph(M, N, np.random.default_rng(7))
        L = kw["graph"].L
    fp = PF.no_faults(N, L, device="cpu")
    r0 = _run(inner, faults=fp, **kw)
    r1 = _run(PF.StalenessGuardPolicy(inner=inner), faults=fp, **kw)
    _same_shared_fields(r0, r1)


# ------------------------------------------------------- fault dynamics


def test_scheduled_blackout_masks_service():
    fp = _faults(sched_start=np.array([5.0, 1e9, 1e9], f32),
                 sched_len=np.array([10.0, 0.0, 0.0], f32))
    r = _run(P.QueueLengthPolicy(), faults=fp)
    ec, down = r.energy_cloud.numpy(), r.clouds_down.numpy()
    assert np.all(ec[5:15, 0] == 0.0)
    assert np.all(down[5:15] >= 1.0) and np.all(down[:5] == 0.0) and np.all(down[15:] == 0.0)


def test_telemetry_dropout_freezes_view():
    r = _run(P.CarbonIntensityPolicy(V=0.05), faults=_faults(telem_p_down=1.0, telem_p_up=0.0))
    np.testing.assert_array_equal(r.stale.numpy(), np.arange(1, T + 1, dtype=f32))
    assert float(r.emissions.sum()) > 0.0


def test_hard_link_flap_no_nan_nothing_delivered():
    g = PN.direct_graph(M, N)
    fp = PF.make_faults(N, g.L, device="cpu", link_p_down=1.0, link_p_up=0.0, link_floor=0.0)
    r = _run(PN.NetworkAwareDPPPolicy(V=0.05), graph=g, faults=fp)
    for name in type(r)._fields:
        leaf = getattr(r, name)
        if leaf is not None:
            assert not torch.isnan(leaf).any(), name
    assert float(r.delivered.sum()) == 0.0
    np.testing.assert_array_equal(r.links_down.numpy(), np.full(T, g.L, f32))


def test_step_links_unit_scale_is_a_no_op():
    g = PN.star_graph(M, N, np.random.default_rng(2)).to("cpu")
    ls = PN.init_links(M, g.L, device="cpu")
    dt = torch.from_numpy(np.random.default_rng(3).integers(0, 9, (M, g.L)).astype(f32))
    a, da = PN.step_links(ls, g, dt)
    b, db = PN.step_links(ls, g, dt, bw_scale=torch.ones(g.L))
    assert torch.equal(da, db) and torch.equal(a.Qt, b.Qt) and torch.equal(a.prog, b.prog)


def test_total_task_failure_conservation():
    r = _run(P.QueueLengthPolicy(), faults=_faults(task_p_fail=1.0))
    np.testing.assert_array_equal(r.failed.numpy(), r.processed.numpy())
    assert float(r.processed.sum()) > 0.0 and float(r.wasted.sum()) > 0.0
    rhs = np.cumsum(r.arrived.numpy()) - np.cumsum(r.processed.numpy()) + np.cumsum(
        r.failed.numpy())
    np.testing.assert_array_equal(r.backlog.numpy(), rhs)


def test_retry_pool_releases_after_recovery():
    fp = _faults(task_p_fail=np.array([0.5, 0.0, 0.0], f32),
                 sched_start=np.array([10.0, 1e9, 1e9], f32),
                 sched_len=np.array([6.0, 0.0, 0.0], f32))
    r = _run(P.QueueLengthPolicy(), T=96, faults=fp)
    assert float(r.requeued.sum()) > 0.0
    assert float(r.processed.sum()) > float(r.failed.sum())


# ------------------------------------------------- guard degradation


def _view(stale=0, cloud_on=None):
    on = torch.ones(N) if cloud_on is None else torch.tensor(cloud_on, dtype=torch.float32)
    return PF.FaultView(obs_row=torch.zeros(N + 1), stale=torch.tensor(stale, dtype=torch.int32),
                        cloud_cap=on, cloud_on=on, released=torch.zeros(M, N))


def _state(Qe, Qc):
    return P.NetworkState(Qe=torch.as_tensor(Qe, dtype=torch.float32),
                          Qc=torch.as_tensor(Qc, dtype=torch.float32))


def test_guard_fully_stale_equals_v_zero():
    rng = np.random.default_rng(0)
    spec = tfs._base(M, N)
    state = _state(rng.integers(1, 50, M).astype(f32), rng.integers(0, 50, (M, N)).astype(f32))
    Ce, Cc = torch.tensor(300.0), torch.from_numpy(rng.uniform(0, 700, N).astype(f32))
    a = torch.zeros(M)
    inner = P.CarbonIntensityPolicy(V=0.05)
    act_g = PF.StalenessGuardPolicy(inner=inner, stale_after=8)(state, spec, Ce, Cc, a,
                                                                fault_view=_view(stale=8))
    act_0 = dataclasses.replace(inner, V=0.0)(state, spec, Ce, Cc, a)
    assert torch.equal(act_g.d, act_0.d) and torch.equal(act_g.w, act_0.w)


def test_guard_outage_aware_dispatch_avoids_down_cloud():
    spec = tfs._base(M, N)
    state = _state(np.full(M, 200.0, f32), np.zeros((M, N), f32))
    Ce, Cc, a = torch.tensor(600.0), torch.tensor([1.0, 500.0, 500.0]), torch.zeros(M)
    inner = P.CarbonIntensityPolicy(V=0.05)
    act_g = PF.StalenessGuardPolicy(inner=inner)(state, spec, Ce, Cc, a,
                                                 fault_view=_view(cloud_on=[0.0, 1.0, 1.0]))
    act_i = inner(state, spec, Ce, Cc, a)
    assert float(act_g.d[:, 0].sum()) == 0.0 < float(act_i.d[:, 0].sum())
    assert float(act_g.d.sum()) > 0.0


def test_guard_all_down_stops_dispatch():
    spec = tfs._base(M, N)
    state = _state(np.full(M, 200.0, f32), np.zeros((M, N), f32))
    act = PF.StalenessGuardPolicy(inner=P.CarbonIntensityPolicy(V=0.05))(
        state, spec, torch.tensor(1.0), torch.ones(N), torch.zeros(M),
        fault_view=_view(cloud_on=[0.0, 0.0, 0.0]))
    assert float(act.d.sum()) == 0.0


# ------------------------------------------------- constructors/config


def test_make_faults_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown FaultParams"):
        PF.make_faults(N, device="cpu", typo_rate=0.1)


def test_make_faults_rejects_link_fields_without_L():
    with pytest.raises(ValueError, match="need L"):
        PF.make_faults(N, device="cpu", link_p_down=0.1)


def test_guard_validates_construction():
    with pytest.raises(ValueError, match="stale_after"):
        PF.StalenessGuardPolicy(inner=P.CarbonIntensityPolicy(), stale_after=0)
    with pytest.raises(ValueError, match="V field"):
        PF.StalenessGuardPolicy(inner=object())


def test_network_faults_need_link_fields():
    g = PN.star_graph(M, N, np.random.default_rng(7))
    with pytest.raises(ValueError, match="link fields"):
        _run(PN.NetworkAwareDPPPolicy(), T=2, graph=g, faults=PF.no_faults(N, device="cpu"))


@pytest.mark.parametrize("kind", ["regional-blackout", "telemetry-brownout", "flappy-uplink"])
def test_fault_scenarios_equal_jax(kind):
    """Every registered scenario's per-lane parameters, bit for bit
    (lane j from default_rng((seed, 9, j)))."""
    wan = kind == "flappy-uplink"
    build = (lambda m: m.build_network_fleet(["congested-uplink"], per_kind=3, M=M, N=N, Tc=8,
                                             seed=0, **({} if m is jfs else {"device": "cpu"}))
             ) if wan else (lambda m: m.build_fleet(["diurnal-slack"], per_kind=3, M=M, N=N, Tc=8,
                                                    seed=0, **({} if m is jfs else
                                                               {"device": "cpu"})))
    jf, tf = jfs.with_faults(build(jfs), kind, seed=5), tfs.with_faults(build(tfs), kind, seed=5)
    for name in PF.FaultParams._fields:
        a, b = getattr(tf.faults, name), getattr(jf.faults, name)
        assert (a is None) == (b is None) and (not wan or a is not None or "link" not in name)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert tf.faults.cloud_p_down.shape == (3, N)
    if not wan:
        with pytest.raises(ValueError):
            tfs.with_faults(build(tfs), "flappy-uplink")
    with pytest.raises(KeyError, match="unknown fault scenario"):
        tfs.with_faults(build(tfs), "no-such-fault")


def test_faults_from_reference_and_stacking():
    jp = JF.make_faults(N, 6, task_p_fail=0.2, link_floor=0.5)
    tp = convert.faults_from_reference(jp, device="cpu")
    for name in PF.FaultParams._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    stacked = PF.stack_faults([tp, tp])
    assert stacked.link_floor.shape == (2, 6) and stacked.backoff_max.shape == (2,)
    with pytest.raises(ValueError, match="None in some lanes"):
        PF.stack_faults([tp, PF.no_faults(N, device="cpu")])


# --------------------------------------------------------- the fault stream


@pytest.mark.parametrize("L", [None, 7])
def test_fault_draws_are_jax_key_walk(L):
    """fold_in(k_fault, t), split two ways, the first split five ways:
    each uniform bitwise JAX's, for single keys and lanes of keys."""
    Mx, Nx = 3, 4
    for t in (0, 1, 191, 2**31 + 5):
        tk = R.split(R.PRNGKey(11, device="cpu"), 3)
        jk = jax.random.split(jax.random.PRNGKey(11), 3)
        u = PF.fault_draws(R.fold_in(tk, PF.FAULT_STREAM_SALT), t, Mx, Nx, L)

        def one(k, L=L):
            kt = jax.random.fold_in(jax.random.fold_in(k, JF.model.FAULT_STREAM_SALT), t)
            k_step, k_fail = jax.random.split(kt)
            kc, kb, kt_, kl, kr = jax.random.split(k_step, 5)
            out = [jax.random.uniform(kc, (Nx,)), jax.random.uniform(kb, (Nx,)),
                   jax.random.uniform(kt_, ()), jax.random.uniform(kr, (Mx, Nx)),
                   jax.random.uniform(k_fail, (Mx, Nx))]
            return out + ([jax.random.uniform(kl, (L,))] if L else [])
        want = jax.vmap(one)(jk)
        for got, ref in zip((u.cloud, u.brown, u.telem, u.rel, u.fail) + ((u.link,) if L else ()),
                            want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (u.link is None) == (L is None)


def _path_key(k, path):
    for i in path:
        k = R.fold_in(k, i)  # child i of any split is threefry(k, (0, i))
    return k


def test_paths_plain_is_the_random_composition():
    """threefry_draw(paths=...)'s plain version against split / fold_in /
    uniform written out: a path deeper than two, a segment of length 1,
    an empty one, a path of length 0 (the folded key itself)."""
    keys = R.split(R.PRNGKey(3, device="cpu"), 5)
    paths = (((2, 0, 7), 9), ((1,), 1), ((0, 4), 0), ((), 6), ((5, 5, 5, 5), 3))
    got = ops.threefry_draw(keys, 9, 19, paths=paths)
    k = R.fold_in(keys, 9)
    assert torch.equal(got, torch.cat([R.uniform(_path_key(k, p), (n,)) for p, n in paths],
                                      dim=-1))
    for bad in (dict(paths=(((0,), 3),)),                    # lengths do not add up to n
                dict(paths=(((0, 1, 2, 3, 4), 19),)),         # deeper than 4
                dict(paths=(((0,), 2),) * 8 + (((1,), 3),)),  # 9 segments
                dict(paths=(((0,), 19),), seg=3)):
        with pytest.raises(ValueError):
            ops.threefry_draw(keys, 9, 19, **bad)
    # every finish takes a path table: bits from the same keys
    bits = ops.threefry_draw(keys, 9, 19, paths=paths, finish="bits")
    assert torch.equal(bits, torch.cat([R.random_bits(_path_key(k, p), (n,)) for p, n in paths],
                                       dim=-1))


def test_paths_launch_counter():
    """The paths= launches have a counter of their own beside the draw's
    (a CPU draw is the plain version and counts in neither), and
    `reset_launch_counts` sets both to 0."""
    from repro_torch.kernels import threefry as tfk
    ops.reset_launch_counts()
    keys = R.split(R.PRNGKey(3, device="cpu"), 2)
    paths = PF.fault_paths(1, 2)
    ops.threefry_draw(keys, 1, sum(n for _, n in paths), paths=paths)
    assert ops.path_launches() == 0 and ops.launch_counts()["threefry_draw"] == 0
    tfk.path_launches = tfk.launches = 3
    assert ops.path_launches() == 3
    ops.reset_launch_counts()
    assert ops.path_launches() == 0 and ops.launch_counts()["threefry_draw"] == 0


# ------------------------------------------------------------ parity vs JAX


_SCENARIOS = {
    "blackout": dict(sched_start=np.array([5.0, 0.0, 0.0, 0.0, 0.0], f32),
                     sched_len=np.array([10.0, 0.0, 0.0, 0.0, 0.0], f32),
                     cloud_p_down=0.05, cloud_p_up=0.3, task_p_fail=0.1, backoff_max=6.0),
    # a brown floor that is not a power of two: Pc * cap rounds before the fill
    "brownout": dict(telem_p_down=0.3, telem_p_up=0.2, brown_p_start=0.2, brown_p_end=0.3,
                     brown_floor=0.37, task_p_fail=0.05),
    "failures": dict(task_p_fail=np.array([0.3, 0.02, 0.6, 0.0, 0.1], f32), backoff_max=15.0,
                     cloud_p_down=0.1, cloud_p_up=0.5),
}
_POLICIES = {
    "carbon": (lambda: J.CarbonIntensityPolicy(V=0.05), lambda: P.CarbonIntensityPolicy(V=0.05)),
    "queue": (J.QueueLengthPolicy, P.QueueLengthPolicy),
    "guard": (lambda: JF.StalenessGuardPolicy(J.CarbonIntensityPolicy(V=0.05), stale_after=7),
              lambda: PF.StalenessGuardPolicy(P.CarbonIntensityPolicy(V=0.05), stale_after=7)),
}
_TABLE = np.asarray(J.carbon.diurnal_table(96, 5, np.random.default_rng(3)))


def _jax_single(jpol, jfp, T=T, seed=1, **kw):
    return jax.jit(lambda fp, k: J.simulate(
        jpol, jfs._base(5, 5), J.TableCarbonSource(table=_TABLE), J.UniformArrivals(M=5, amax=300),
        T, k, faults=fp, **kw))(jfp, jax.random.PRNGKey(seed))


def _port_single(tpol, tfp, T=T, seed=1, **kw):
    return P.simulate(tpol, tfs._base(5, 5), P.TableCarbonSource(table=_TABLE),
                      P.UniformArrivals(M=5, amax=300), T, seed, device="cpu", faults=tfp, **kw)


@pytest.mark.parametrize("scen", list(_SCENARIOS))
@pytest.mark.parametrize("pname", list(_POLICIES))
def test_simulate_faulted_matches_jax(scen, pname):
    jp, tp = (f() for f in _POLICIES[pname])
    ref = _jax_single(jp, JF.make_faults(5, **_SCENARIOS[scen]))
    got = _port_single(tp, PF.make_faults(5, device="cpu", **_SCENARIOS[scen]))
    assert isinstance(got, PF.FaultSimResult)
    _assert_matches(got, ref)
    assert float(got.failed.sum()) > 0 or scen == "brownout"


@pytest.mark.parametrize("record", ["summary", 8])
def test_record_modes_keep_the_scalars(record):
    tp = PF.StalenessGuardPolicy(P.CarbonIntensityPolicy(V=0.05))
    fp = PF.make_faults(5, device="cpu", **_SCENARIOS["blackout"])
    full = _port_single(tp, fp)
    part = _port_single(tp, fp, record=record)
    for name in FLOATS + INTS[3:]:
        assert torch.equal(getattr(full, name), getattr(part, name)), name
    assert torch.equal(part.retry[-1], full.retry[-1]) and torch.equal(part.Qc[-1], full.Qc[-1])
    assert part.retry.shape[0] == (1 if record == "summary" else T // record)


def test_forecaster_sees_the_observed_row():
    """A faulted Lookahead run fed by a forecaster: the forecaster is
    updated with the (frozen) observed row, as in JAX."""
    import repro.forecast as JFc
    import repro_torch.forecast as PFc

    kw = _SCENARIOS["brownout"]
    ref = _jax_single(J.LookaheadDPPPolicy(V=0.05, H=4), JF.make_faults(5, **kw),
                      forecaster=JFc.EWMAForecaster(H=4))
    got = _port_single(P.LookaheadDPPPolicy(V=0.05, H=4), PF.make_faults(5, device="cpu", **kw),
                       forecaster=PFc.EWMAForecaster(H=4))
    _assert_matches(got, ref)


@pytest.mark.parametrize("pname", ["aware", "guard", "static"])
def test_simulate_network_faulted_matches_jax(pname):
    jfl = jfs.build_network_fleet(["congested-uplink"], per_kind=1, Tc=96, seed=3)
    jgraph = JN.LinkGraph(*(np.asarray(x)[0] for x in jfl.graph))
    tgraph = convert.graph_from_reference(jgraph, device="cpu")
    L = tgraph.L
    kw = dict(link_p_down=np.where(np.arange(L) % 2 == 1, 0.3, 0.05).astype(f32), link_p_up=0.35,
              link_floor=np.where(np.arange(L) < 4, 0.0, 0.5).astype(f32), task_p_fail=0.05,
              telem_p_down=0.2, telem_p_up=0.3)
    jpol, tpol = {"aware": (JN.NetworkAwareDPPPolicy(V=0.05), PN.NetworkAwareDPPPolicy(V=0.05)),
                  "guard": (JF.StalenessGuardPolicy(JN.NetworkAwareDPPPolicy(V=0.05)),
                            PF.StalenessGuardPolicy(PN.NetworkAwareDPPPolicy(V=0.05))),
                  "static": (JN.StaticRoutePolicy(J.QueueLengthPolicy()),
                             PN.StaticRoutePolicy(P.QueueLengthPolicy()))}[pname]
    jspec = J.NetworkSpec(*(np.asarray(x)[0] for x in jfl.spec))
    table = np.asarray(jfl.carbon)[0]
    amax = float(np.asarray(jfl.arrival_amax)[0].max())
    ref = jax.jit(lambda g, fp, k: J.simulate(
        jpol, jspec, J.TableCarbonSource(table=table), J.UniformArrivals(M=5, amax=int(amax)), T,
        k, graph=g, faults=fp))(jgraph, JF.make_faults(5, L, **kw), jax.random.PRNGKey(2))
    got = P.simulate(tpol, convert.from_reference(jspec, device="cpu"),
                     P.TableCarbonSource(table=table), P.UniformArrivals(M=5, amax=int(amax)), T, 2,
                     device="cpu", graph=tgraph, faults=PF.make_faults(5, L, device="cpu", **kw))
    assert isinstance(got, PF.NetFaultSimResult)
    _assert_matches(got, ref, ints=INTS + ("Qt", "delivered", "links_down"),
                    floats=FLOATS + ("energy_transfer",))
    assert float(got.links_down.sum()) > 0


# ------------------------------------------------- XLA's roundings in the scan


@dataclasses.dataclass(frozen=True)
class _JProbe:
    """A JAX 'policy' that dispatches its own V to (0, 0): `dispatched`
    then reads the V the guard hands it, bit for bit."""

    V: float = 0.3

    def __call__(self, state, spec, Ce, Cc, arrivals, key=None, fault_view=None,
                 deadline_view=None):
        V = jnp.asarray(self.V, jnp.float32)
        return JAction(d=jnp.zeros_like(state.Qc).at[0, 0].set(V), w=jnp.zeros_like(state.Qc))


@dataclasses.dataclass(frozen=True)
class _TProbe:
    V: float = 0.3

    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, *, fault_view=None):
        d = torch.zeros_like(state.Qc)
        d[..., 0, 0] = torch.as_tensor(self.V, dtype=torch.float32)
        return PAction(d=d, w=torch.zeros_like(state.Qc))


@pytest.mark.parametrize("stale_after", [6, 7, 10])
def test_guard_decay_is_contracted_in_the_scan(stale_after):
    """Inside the scan XLA computes 1 - stale/s0 as fma(-stale, f32(1/s0),
    1): at these stale_after the correctly rounded quotient differs at
    one or two counts, which the run reaches, and JAX's V_eff is the
    FMA's."""
    kw = dict(telem_p_down=0.6, telem_p_up=0.03)
    ref = _jax_single(JF.StalenessGuardPolicy(_JProbe(), stale_after=stale_after),
                      JF.make_faults(5, **kw), T=64, seed=4)
    got = _port_single(PF.StalenessGuardPolicy(_TProbe(), stale_after=stale_after),
                       PF.make_faults(5, device="cpu", **kw), T=64, seed=4)
    np.testing.assert_array_equal(got.dispatched.numpy(), np.asarray(ref.dispatched))
    stale = np.asarray(ref.stale)
    divided = np.clip(f32(1.0) - stale / f32(stale_after), 0, 1).astype(f32) * f32(0.3)
    assert not np.array_equal(divided, np.asarray(ref.dispatched))


@pytest.mark.parametrize("pname", ["queue", "carbon"])
def test_failure_draw_is_fused_in_the_scan(pname):
    """floor(w_eff * p + u) at slot 0 of a run from a loaded state, with
    p chosen so that the product rounded first would flip one floor
    against the single-rounded FMA: JAX's count inside the scan is the
    FMA's (each direction of flip is met by one of the two policies)."""
    jp, tp = (f() for f in _POLICIES[pname])
    rng = np.random.default_rng(5)
    Qe0, Qc0 = rng.integers(0, 300, 5).astype(f32), rng.integers(20, 400, (5, 5)).astype(f32)
    state = P.NetworkState(Qe=torch.from_numpy(Qe0), Qc=torch.from_numpy(Qc0))
    Ce, Cc = P.TableCarbonSource(table=_TABLE)(0, None, "cpu")
    w = tp(state, tfs._base(5, 5), Ce, Cc).w.numpy()
    u = PF.fault_draws(R.fold_in(R.PRNGKey(1, device="cpu"), PF.FAULT_STREAM_SALT), 0, 5, 5).fail
    u = u.numpy()

    def flip(m, n):  # a p near an integer's boundary where the two forms part
        target = f32((np.floor(w[m, n] * f32(0.3) + u[m, n]) + 1 - u[m, n]) / w[m, n])
        for step in range(-64, 65):
            cand = (target.view(np.int32) + step).view(f32)
            fused = float(torch.floor(fma_f32(torch.tensor(w[m, n]), float(cand),
                                              torch.tensor(u[m, n]))))
            if fused != float(np.floor(f32(f32(w[m, n] * cand) + u[m, n]))):
                return cand
        return None

    found = next((n, c) for n in range(5) for m in range(5)
                 if w[m, n] >= 2 and (c := flip(m, n)) is not None)
    p = np.zeros(5, f32)
    p[found[0]] = found[1]
    ref = _jax_single(jp, JF.make_faults(5, task_p_fail=p), T=2,
                      state0=J.NetworkState(Qe=jnp.asarray(Qe0), Qc=jnp.asarray(Qc0)))
    got = _port_single(tp, PF.make_faults(5, device="cpu", task_p_fail=p), T=2, state0=state)
    _assert_matches(got, ref)
    unfused = np.floor((w * p[None, :]).astype(f32) + u).sum(dtype=f32)
    assert float(unfused) != float(np.asarray(ref.failed)[0])


# --------------------------------------------------------- conservation


@settings(max_examples=8, deadline=None)
@given(p_fail=st.floats(0.0, 1.0, width=32), p_down=st.floats(0.0, 0.5, width=32),
       p_up=st.floats(0.0, 1.0, width=32), telem=st.floats(0.0, 1.0, width=32),
       seed=st.integers(0, 2**31 - 1))
def test_task_conservation_any_fault_stream(p_fail, p_down, p_up, telem, seed):
    """cum(arrived) = Qe + Qc + retry + cum(processed) - cum(failed),
    exactly in float32, every slot, for any rates (bounds exact in
    float32: 0.0, 0.5, 1.0)."""
    fp = _faults(task_p_fail=p_fail, cloud_p_down=p_down, cloud_p_up=p_up, telem_p_down=telem,
                 telem_p_up=0.5, brown_p_start=0.3, brown_p_end=0.3, brown_floor=0.5)
    spec, src, arr, _ = _setup()
    r = P.simulate(PF.StalenessGuardPolicy(P.CarbonIntensityPolicy(V=0.05)), spec, src, arr, 16,
                   seed, device="cpu", faults=fp)
    held = r.Qe.sum(-1) + r.Qc.sum((-2, -1)) + r.retry.sum((-2, -1))
    np.testing.assert_array_equal(r.backlog.numpy(), held.numpy())
    rhs = np.cumsum(r.arrived.numpy()) - np.cumsum(r.processed.numpy()) + np.cumsum(
        r.failed.numpy())
    np.testing.assert_array_equal(r.backlog.numpy(), rhs.astype(f32))
