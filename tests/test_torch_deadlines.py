"""The port's deadline layer (`repro_torch.deadlines`) against the JAX
package's `repro.deadlines`, on single runs.

Every anchor of `tests/test_deadlines.py` has its twin here: the slot
mechanics (oldest-first drain, expiry, admission with a cold estimator,
the view, validation), the infinite-deadline anchor on the plain, WAN,
faulted and faulted WAN loops (every shared field bitwise the run
without deadlines), summary and full records with equal scalars, and the
served trajectory equal to the batch one.

Against JAX (its run under `jit` with the deadline parameters an
argument, inside the simulator's scan) the queues, the age rings `Qd`
and the missed, shed and admitted counts are bitwise, emissions within
rtol 1e-6, for every policy of the layer and the loops it threads
through. The roundings XLA gives inside the scan are held by crafted
cases (ROADMAP hazards 29-32): the EWMA of `mu` is fma(1 - alpha, mu,
alpha * d), the admission cap fma(headroom * mu, deadline + 1, -queued),
SlackThreshold's score updates fma(-(u * (V * C)), p, score) with V a
constant and under the guard, and its urgency fma(-slack, f32(1 / s), 1)
at a slack scale where the quotient differs. Conservation is a
hypothesis property over bounds exact in float32.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

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
from repro.serve import loop as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.serve import loop as tserve  # noqa: E402

f32 = np.float32
T = 40
M, N = 5, 5
INTS = ("Qe", "Qc", "dispatched", "processed")
LEDGER = ("missed", "shed", "admitted", "Qd")
TABLE = np.asarray(J.carbon.diurnal_table(96, N, np.random.default_rng(3)))
ARRIVALS = np.random.default_rng(4).integers(0, 700, (T, M)).astype(f32)  # ~1.4x the edge budget
DL = dict(deadline=np.array([2, 3, 1, 5, 4], f32), window=np.array([2, 3, 1, 5, 4], f32),
          shed_on=1.0, headroom=0.7, alpha=0.3)


def _dl(pkg, **kw):
    kw = dict(DL, **kw)
    return JD.make_deadlines(M, **kw) if pkg == "jax" else PD.make_deadlines(M, device="cpu", **kw)


def _jax_run(jpol, jdl, T=T, state0=None, fc=None, graph=None, faults=None, record="full"):
    arr = jnp.asarray(ARRIVALS)
    return jax.jit(lambda d, g, fp, k: J.simulate(
        jpol, jfs._base(M, N), J.TableCarbonSource(table=TABLE), lambda t, kk: arr[t % T], T, k,
        state0=state0, forecaster=fc, graph=g, faults=fp, deadlines=d, record=record))(
            jdl, graph, faults, jax.random.PRNGKey(1))


def _port_run(tpol, tdl, T=T, state0=None, fc=None, graph=None, faults=None, record="full"):
    arr = torch.from_numpy(ARRIVALS)
    return P.simulate(tpol, tfs._base(M, N), P.TableCarbonSource(table=TABLE),
                      lambda t, key, device: arr[t % T], T, 1, device="cpu", state0=state0,
                      forecaster=fc, graph=graph, faults=faults, deadlines=tdl, record=record)


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


def _same_shared_fields(r0, r1):
    """Every field of the run without deadlines bitwise the anchored run's."""
    for name in type(r0)._fields:
        a, b = getattr(r0, name), getattr(r1, name)
        assert a is None or torch.equal(a, b), name


# ------------------------------------------------------------------ model units


def test_oldest_first_drain():
    p = PD.no_deadlines(1, D=4, device="cpu")
    ds = PD.DeadlineState(Qd=torch.tensor([[2.0, 3.0, 1.0, 4.0]]), mu=torch.zeros(1))
    nxt, admitted, expired, shed = PD.step_deadlines(p, ds, torch.tensor([6.0]),
                                                     torch.tensor([5.0]))
    np.testing.assert_array_equal(nxt.Qd.numpy(), [[5.0, 2.0, 2.0, 0.0]])
    assert float(admitted[0]) == 5.0 and float(expired[0]) == 0.0 and float(shed[0]) == 0.0


def test_expiry_counts_unserved_tasks():
    p = PD.make_deadlines(1, D=4, device="cpu", deadline=0.0)
    ds = PD.DeadlineState(Qd=torch.tensor([[3.0, 0.0, 0.0, 0.0]]), mu=torch.zeros(1))
    nxt, _, expired, _ = PD.step_deadlines(p, ds, torch.tensor([1.0]), torch.tensor([0.0]))
    assert float(expired[0]) == 2.0 and float(nxt.Qd.sum()) == 0.0


def test_admission_sheds_overload_but_cold_estimator_admits():
    p = PD.make_deadlines(1, D=8, device="cpu", deadline=1.0, shed_on=1.0, headroom=1.0)
    nxt, admitted, _, shed = PD.step_deadlines(p, PD.init_deadlines(1, 8, device="cpu"),
                                               torch.tensor([0.0]), torch.tensor([10.0]))
    assert float(admitted[0]) == 10.0 and float(shed[0]) == 0.0
    ds = PD.DeadlineState(Qd=nxt.Qd * 0.0, mu=torch.tensor([2.0]))
    _, admitted, _, shed = PD.step_deadlines(p, ds, torch.tensor([0.0]), torch.tensor([10.0]))
    assert float(admitted[0]) == 4.0 and float(shed[0]) == 6.0


def test_deadline_view_slack_and_due():
    p = PD.make_deadlines(2, D=4, device="cpu", deadline=[2.0, np.inf])
    ds = PD.DeadlineState(Qd=torch.tensor([[0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0]]),
                          mu=torch.zeros(2))
    v = PD.deadline_view(p, ds)
    assert float(v.slack[0]) == 0.0 and float(v.due[0]) == 1.0
    assert not np.isfinite(float(v.slack[1])) and float(v.due[1]) == 0.0


def test_make_deadlines_validates():
    with pytest.raises(ValueError, match="finite deadlines"):
        PD.make_deadlines(2, D=8, device="cpu", deadline=9.0)
    with pytest.raises(ValueError, match="finite deadlines"):
        PD.make_deadlines(2, D=8, device="cpu", deadline=torch.tensor([-1.0, 2.0]))
    with pytest.raises(ValueError, match="unknown DeadlineParams"):
        PD.make_deadlines(2, device="cpu", deadlnie=3.0)
    p = PD.make_deadlines(3, D=6, device="cpu", deadline=[1.0, np.inf, 5.0], shed_on=1.0)
    assert p.D == 6 and p.deadline.shape == (3,) and p.shed_on.shape == ()


@pytest.mark.parametrize("lanes", [(), (3,)])
def test_step_and_view_equal_jax(lanes):
    """A few random slots of the deadline step and the view, against
    jit(step_deadlines) / jit(vmap(...)), bitwise (mu included)."""
    rng = np.random.default_rng(11)
    D = 6
    shape = lanes + (7,)
    kw = dict(deadline=np.where(rng.random(shape) < 0.3, np.inf,
                                rng.integers(0, D, shape)).astype(f32),
              window=rng.integers(0, 9, shape).astype(f32))
    scal = {k: rng.uniform(lo, hi, lanes).astype(f32) for k, lo, hi in (
        ("headroom", 0.5, 1.3), ("alpha", 0.05, 0.9))}
    scal["shed_on"] = np.ones(lanes, f32)
    if lanes:
        every = {**kw, **scal}
        jp = JD.stack_deadlines([JD.make_deadlines(7, D, **{k: v[f] for k, v in every.items()})
                                 for f in range(lanes[0])])
        step = jax.jit(jax.vmap(JD.step_deadlines))
        view = jax.jit(jax.vmap(JD.deadline_view))
    else:
        jp = JD.make_deadlines(7, D, **kw, **scal)
        step, view = jax.jit(JD.step_deadlines), jax.jit(JD.deadline_view)
    tp = convert.deadlines_from_reference(jp, device="cpu")
    jds = JD.DeadlineState(Qd=jnp.zeros(shape + (D,)), mu=jnp.zeros(shape))
    tds = PD.DeadlineState(Qd=torch.zeros(shape + (D,)), mu=torch.zeros(shape))
    for _ in range(12):
        d = rng.integers(0, 60, shape).astype(f32)
        a = rng.integers(0, 80, shape).astype(f32)
        jv, tv = view(jp, jds), PD.deadline_view(tp, tds)
        for name in ("slack", "due"):
            np.testing.assert_array_equal(getattr(tv, name).numpy(), np.asarray(getattr(jv, name)))
        jout, tout = step(jp, jds, jnp.asarray(d), jnp.asarray(a)), PD.step_deadlines(
            tp, tds, torch.from_numpy(d), torch.from_numpy(a))
        for j, t in zip(jax.tree.leaves(jout), [tout[0].Qd, tout[0].mu, *tout[1:]]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        jds, tds = jout[0], tout[0]
    assert float(tds.mu.sum()) > 0


# -------------------------------------------------------- the anchor, every loop


def test_anchor_plain():
    pol = P.CarbonIntensityPolicy(V=0.05)
    r0 = _port_run(pol, None)
    r1 = _port_run(pol, PD.no_deadlines(M, device="cpu"))
    _same_shared_fields(r0, r1)
    assert r0.deadlines is None and float(r1.deadlines.missed.sum()) == 0.0
    assert float(r1.deadlines.shed.sum()) == 0.0
    assert torch.equal(r1.deadlines.Qd.sum(-1), r1.Qe)  # the rings shadow Qe exactly


@pytest.mark.parametrize("pname", ["aware", "static"])
def test_anchor_wan(pname):
    g = PN.star_graph(M, N, np.random.default_rng(0))
    pol = (PN.NetworkAwareDPPPolicy(V=0.05) if pname == "aware"
           else PN.StaticRoutePolicy(PD.SlackThresholdPolicy(V=0.05)))
    r0 = _port_run(pol, None, graph=g)
    r1 = _port_run(pol, PD.no_deadlines(M, device="cpu"), graph=g)
    _same_shared_fields(r0, r1)


def test_anchor_faulted():
    fp = PF.make_faults(N, device="cpu", cloud_p_down=0.02, cloud_p_up=0.3, task_p_fail=0.05,
                        telem_p_down=0.1, telem_p_up=0.2)
    pol = PF.StalenessGuardPolicy(inner=P.CarbonIntensityPolicy(V=0.05))
    r0 = _port_run(pol, None, faults=fp)
    r1 = _port_run(pol, PD.no_deadlines(M, device="cpu"), faults=fp)
    _same_shared_fields(r0, r1)


def test_anchor_faulted_wan():
    g = PN.star_graph(M, N, np.random.default_rng(0))
    fp = PF.make_faults(N, g.L, device="cpu", link_p_down=0.1, link_p_up=0.3, task_p_fail=0.02)
    pol = PF.StalenessGuardPolicy(inner=PN.NetworkAwareDPPPolicy(V=0.05))
    r0 = _port_run(pol, None, graph=g, faults=fp)
    r1 = _port_run(pol, PD.no_deadlines(M, device="cpu"), graph=g, faults=fp)
    _same_shared_fields(r0, r1)


@pytest.mark.parametrize("pname", ["slack", "wait", "edd"])
def test_policies_without_a_view_are_their_parents(pname):
    """deadline_view=None (and, for WaitAwhile, no forecast) is the parent
    policy bitwise; so is SlackThreshold on infinite deadlines (u = 0,
    due = 0: exact no-ops)."""
    parent, pol = {"slack": (P.LookaheadDPPPolicy(V=0.05, H=1), PD.SlackThresholdPolicy(V=0.05)),
                   "wait": (P.LookaheadDPPPolicy(V=0.05), PD.WaitAwhilePolicy(V=0.05)),
                   "edd": (None, PD.EDDPolicy())}[pname]
    if parent is not None:
        _same_shared_fields(_port_run(parent, None), _port_run(pol, None))
    if pname == "slack":
        _same_shared_fields(_port_run(parent, None),
                            _port_run(pol, PD.no_deadlines(M, device="cpu")))
    else:
        rng = np.random.default_rng(2)
        state = P.NetworkState(Qe=torch.from_numpy(rng.integers(0, 50, M).astype(f32)),
                               Qc=torch.from_numpy(rng.integers(0, 50, (M, N)).astype(f32)))
        Ce, Cc = torch.tensor(300.0), torch.from_numpy(TABLE[0, 1:])
        view = PD.deadline_view(PD.no_deadlines(M, device="cpu"),
                                PD.init_deadlines(M, 32, device="cpu"))
        a, b = pol(state, tfs._base(M, N), Ce, Cc), pol(state, tfs._base(M, N), Ce, Cc,
                                                          deadline_view=view)
        assert torch.equal(a.d, b.d) and torch.equal(a.w, b.w)


# ------------------------------------------------------------------ parity vs JAX


_POLICIES = {
    "carbon": (lambda: J.CarbonIntensityPolicy(V=0.05), lambda: P.CarbonIntensityPolicy(V=0.05)),
    "queue": (J.QueueLengthPolicy, P.QueueLengthPolicy),
    "slack": (lambda: JD.SlackThresholdPolicy(V=0.05), lambda: PD.SlackThresholdPolicy(V=0.05)),
    "slack_s3": (lambda: JD.SlackThresholdPolicy(V=0.05, slack_scale=3.0, due_push=50.0),
                 lambda: PD.SlackThresholdPolicy(V=0.05, slack_scale=3.0, due_push=50.0)),
    "edd": (JD.EDDPolicy, PD.EDDPolicy),
}


@pytest.mark.parametrize("shed", [0.0, 1.0])
@pytest.mark.parametrize("pname", list(_POLICIES))
def test_simulate_with_deadlines_matches_jax(pname, shed):
    jp, tp = (f() for f in _POLICIES[pname])
    ref = _jax_run(jp, _dl("jax", shed_on=shed))
    got = _port_run(tp, _dl("port", shed_on=shed))
    _assert_matches(got, ref)
    assert float(got.deadlines.missed.sum()) > 0 or float(got.deadlines.shed.sum()) > 0 \
        or pname in ("slack", "slack_s3", "edd")


@pytest.mark.parametrize("fname", ["seasonal", "clairvoyant"])
@pytest.mark.parametrize("pname", ["wait", "slack_la"])
def test_forecast_policies_with_deadlines_match_jax(pname, fname):
    """WaitAwhile and a lookahead SlackThreshold fed by a forecaster."""
    jfc, tfc = {"seasonal": (JFc.SeasonalNaiveForecaster(H=4, period=8),
                             PFc.SeasonalNaiveForecaster(H=4, period=8)),
                "clairvoyant": (JFc.ClairvoyantTableForecaster(H=4),
                                PFc.ClairvoyantTableForecaster(H=4))}[fname]
    jp, tp = {"wait": (JD.WaitAwhilePolicy(V=0.05, H=4, J=2),
                       PD.WaitAwhilePolicy(V=0.05, H=4, J=2)),
              "slack_la": (JD.SlackThresholdPolicy(V=0.05, H=4),
                           PD.SlackThresholdPolicy(V=0.05, H=4))}[pname]
    kw = dict(deadline=np.array([6, 3, np.inf, 5, 4], f32), window=np.array([3, 8, 2, 0, 4], f32),
              shed_on=0.0)
    ref = _jax_run(jp, _dl("jax", **kw), fc=jfc)
    got = _port_run(tp, _dl("port", **kw), fc=tfc)
    _assert_matches(got, ref)


@pytest.mark.parametrize("pname", ["aware", "static_slack", "static_edd"])
def test_simulate_network_with_deadlines_matches_jax(pname):
    jfl = jfs.build_network_fleet(["congested-uplink"], per_kind=1, Tc=96, seed=3)
    jgraph = JN.LinkGraph(*(np.asarray(x)[0] for x in jfl.graph))
    tgraph = convert.graph_from_reference(jgraph, device="cpu")
    jp, tp = {"aware": (JN.NetworkAwareDPPPolicy(V=0.05), PN.NetworkAwareDPPPolicy(V=0.05)),
              "static_slack": (JN.StaticRoutePolicy(JD.SlackThresholdPolicy(V=0.05)),
                               PN.StaticRoutePolicy(PD.SlackThresholdPolicy(V=0.05))),
              "static_edd": (JN.StaticRoutePolicy(JD.EDDPolicy()),
                             PN.StaticRoutePolicy(PD.EDDPolicy()))}[pname]
    ref = _jax_run(jp, _dl("jax"), graph=jgraph)
    got = _port_run(tp, _dl("port"), graph=tgraph)
    assert isinstance(got, PN.NetSimResult)
    _assert_matches(got, ref, ints=INTS + ("Qt", "delivered"),
                    floats=("emissions", "energy_edge", "energy_transfer", "energy_cloud"))


_FAULTS = dict(sched_start=np.array([5.0, 0.0, 0.0, 0.0, 0.0], f32),
               sched_len=np.array([10.0, 0.0, 0.0, 0.0, 0.0], f32), cloud_p_down=0.05,
               cloud_p_up=0.3, task_p_fail=0.1, telem_p_down=0.2, telem_p_up=0.3)
FAULT_INTS = INTS + ("retry", "arrived", "failed", "requeued", "stale", "clouds_down", "backlog")


@pytest.mark.parametrize("pname", ["guard_slack", "edd", "carbon"])
def test_simulate_faulted_with_deadlines_matches_jax(pname):
    jp, tp = {"guard_slack": (JF.StalenessGuardPolicy(JD.SlackThresholdPolicy(V=0.05)),
                              PF.StalenessGuardPolicy(PD.SlackThresholdPolicy(V=0.05))),
              "edd": (JD.EDDPolicy(), PD.EDDPolicy()),
              "carbon": (J.CarbonIntensityPolicy(V=0.05), P.CarbonIntensityPolicy(V=0.05))}[pname]
    ref = _jax_run(jp, _dl("jax"), faults=JF.make_faults(N, **_FAULTS))
    got = _port_run(tp, _dl("port"), faults=PF.make_faults(N, device="cpu", **_FAULTS))
    assert isinstance(got, PF.FaultSimResult)
    _assert_matches(got, ref, ints=FAULT_INTS)


def test_simulate_network_faulted_with_deadlines_matches_jax():
    jfl = jfs.build_network_fleet(["congested-uplink"], per_kind=1, Tc=96, seed=3)
    jgraph = JN.LinkGraph(*(np.asarray(x)[0] for x in jfl.graph))
    tgraph = convert.graph_from_reference(jgraph, device="cpu")
    L = tgraph.L
    kw = dict(link_p_down=0.2, link_p_up=0.35, link_floor=0.0, task_p_fail=0.05,
              telem_p_down=0.2, telem_p_up=0.3)
    ref = _jax_run(JF.StalenessGuardPolicy(JN.NetworkAwareDPPPolicy(V=0.05)), _dl("jax"),
                   graph=jgraph, faults=JF.make_faults(N, L, **kw))
    got = _port_run(PF.StalenessGuardPolicy(PN.NetworkAwareDPPPolicy(V=0.05)), _dl("port"),
                    graph=tgraph, faults=PF.make_faults(N, L, device="cpu", **kw))
    assert isinstance(got, PF.NetFaultSimResult)
    _assert_matches(got, ref, ints=FAULT_INTS + ("Qt", "delivered", "links_down"),
                    floats=("emissions", "energy_edge", "energy_transfer", "energy_cloud",
                            "wasted"))


@pytest.mark.parametrize("record", ["summary", 8])
def test_record_modes_keep_the_scalars(record):
    tp = PD.SlackThresholdPolicy(V=0.05)
    full = _port_run(tp, _dl("port"))
    part = _port_run(tp, _dl("port"), record=record)
    for name in ("emissions", "cum_emissions", "dispatched", "processed", "energy_edge",
                 "energy_cloud"):
        assert torch.equal(getattr(full, name), getattr(part, name)), name
    for name in ("missed", "shed", "admitted"):
        assert torch.equal(getattr(full.deadlines, name), getattr(part.deadlines, name)), name
    assert part.deadlines.Qd.shape[0] == (1 if record == "summary" else T // record)
    assert torch.equal(part.deadlines.Qd[-1], full.deadlines.Qd[-1])
    if record != "summary":
        assert torch.equal(part.deadlines.Qd, full.deadlines.Qd[record - 1::record])


# ------------------------------------------------- XLA's roundings in the scan


def _one_type(K, pe=1.0, pc=1.0, Pc=1e9):
    fields = dict(pe=np.full(1, pe, f32), pc=np.full((1, 1), pc, f32), Pe=f32(K),
                  Pc=np.full(1, Pc, f32))
    return J.NetworkSpec(**fields), P.NetworkSpec(**fields)


def _crafted(jpol, tpol, K, arrivals, rows, dl_kw, state0=(0.0, 0.0), faults=False,
             pe=1.0, pc=1.0, Pc=1e9, lanes=False):
    """One type, one cloud: both packages from the same state, carbon
    rows and arrival rows; JAX jitted with the deadline parameters an
    argument (or, with `lanes`, two lanes of them under vmap)."""
    jspec, tspec = _one_type(K, pe, pc, Pc)
    arr, tab = np.asarray(arrivals, f32)[:, None], np.asarray(rows, f32)
    Tn = arr.shape[0]
    Qe0, Qc0 = (np.full(1, state0[0], f32), np.full((1, 1), state0[1], f32))
    jd = JD.make_deadlines(1, **dl_kw)
    fkw = dict(faults=JF.no_faults(1)) if faults else {}

    def one(d):
        return J.simulate(jpol, jspec, J.TableCarbonSource(table=jnp.asarray(tab)),
                          lambda t, k: jnp.asarray(arr)[t], Tn, jax.random.PRNGKey(0),
                          state0=J.NetworkState(Qe=jnp.asarray(Qe0), Qc=jnp.asarray(Qc0)),
                          deadlines=d, **fkw)
    if lanes:
        ref = jax.tree.map(lambda x: x[1], jax.jit(jax.vmap(one))(JD.stack_deadlines([jd, jd])))
    else:
        ref = jax.jit(one)(jd)
    at = torch.from_numpy(arr)
    got = P.simulate(tpol, tspec, P.TableCarbonSource(table=tab), lambda t, k, d: at[t], Tn, 0,
                     device="cpu", state0=P.NetworkState(Qe=torch.from_numpy(Qe0),
                                                         Qc=torch.from_numpy(Qc0)),
                     deadlines=PD.make_deadlines(1, device="cpu", **dl_kw),
                     **(dict(faults=PF.no_faults(1, device="cpu")) if faults else {}))
    _assert_matches(got, ref, ints=INTS, floats=())
    return ref


def _rn(x):
    return np.float32(np.float64(x))


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("pname", ["queue", "carbon"])
def test_cap_is_contracted_in_the_scan(pname, lanes):
    """Hazard 30. Slot 1 dispatches K of a0 = K + q, so mu = alpha * K
    and q tasks stay queued; the cap's three candidate forms straddle
    the integer 6616, and JAX's shed count at slot 1 is
    fma(headroom * mu, deadline + 1, -queued)'s."""
    alpha, h, dl, K, q = 0.8149325251579285, 1.1342805624008179, 4.0, 1999.0, 2623.0
    mu = _rn(f32(alpha) * f32(K))
    hm = _rn(f32(h) * mu)
    forms = {"unfused": _rn(_rn(hm * f32(dl + 1)) - f32(q)),
             "fma": _rn(np.float64(hm) * (dl + 1) - q),
             "fma_late": _rn(np.float64(f32(h)) * np.float64(_rn(mu * f32(dl + 1))) - q)}
    assert np.floor(forms["fma"]) == 6615 and np.floor(forms["unfused"]) == \
        np.floor(forms["fma_late"]) == 6616
    jp, tp = _POLICIES[pname]
    jpol, tpol = jp(), tp()
    if pname == "carbon":  # V = 0: carbon-blind, dispatches the same counts
        jpol, tpol = J.CarbonIntensityPolicy(V=0.0), P.CarbonIntensityPolicy(V=0.0)
    ref = _crafted(jpol, tpol, K, [K + q, 20000.0], [[100.0, 100.0]] * 2,
                   dict(deadline=dl, shed_on=1.0, headroom=h, alpha=alpha), lanes=lanes)
    np.testing.assert_array_equal(np.asarray(ref.deadlines.shed), [0.0, 20000.0 - 6615.0])


@pytest.mark.parametrize("lanes", [False, True])
def test_mu_ewma_is_contracted_in_the_scan(lanes):
    """Hazard 29. Slot 1 sets mu = alpha * K, slot 2 moves it with d = K:
    the three EWMA forms put the slot-2 cap on either side of 5247, and
    JAX's shed count is fma(1 - alpha, mu, alpha * d)'s, with alpha a
    traced operand (a lane operand with `lanes`)."""
    alpha, h, dl, K, q = 0.38920509815216064, 0.6081820130348206, 5.0, 2346.0, 2466.0
    a, one = f32(alpha), f32(1.0)
    mu1 = _rn(a * f32(K))
    ad = _rn(a * f32(K))
    forms = {"unfused": _rn(_rn((one - a) * mu1) + ad),
             "fma": _rn(np.float64(one - a) * np.float64(mu1) + np.float64(ad)),
             "fma_other": _rn(np.float64(a) * K + np.float64(_rn((one - a) * mu1)))}

    def cap(mu):
        return np.floor(_rn(np.float64(_rn(f32(h) * mu)) * (dl + 1) - (q - K)))
    assert cap(forms["fma"]) == 5246 and cap(forms["unfused"]) == cap(forms["fma_other"]) == 5247
    ref = _crafted(J.QueueLengthPolicy(), P.QueueLengthPolicy(), K, [K + q, 0.0, 30000.0],
                   [[100.0, 100.0]] * 3, dict(deadline=dl, shed_on=1.0, headroom=h, alpha=alpha),
                   lanes=lanes)
    np.testing.assert_array_equal(np.asarray(ref.deadlines.shed), [0.0, 0.0, 30000.0 - 5246.0])


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("side", ["edge", "cloud"])
def test_slack_score_updates_are_contracted_in_the_scan(side, guard):
    """Hazard 31. Slot 0 idles (huge intensities) and leaves one arrival
    in ring 0; at slot 1 its slack is 1, u = 0.75, and the crafted
    intensity puts the score on 0 when u * (V * C) * p is rounded first:
    fma(-(u * (V * C)), p, score) is below 0 and the slot dispatches
    (processes) k, the unfused form would not. V is the dataclass
    constant, and under the guard (no faults) a traced V * 1."""
    big = 1e5
    if side == "edge":
        c, p, k = 553.7535400390625, 2.4559662342071533, 17.0
        rows, state0, kw = [[big, big], [c, big]], (k - 1.0, 0.0), dict(pe=p)
        VC = _rn(f32(0.05) * f32(c))
        score = _rn(np.float64(VC) * np.float64(f32(p))) - k  # fma(VCe, pe, 0) - Qe
    else:
        c, p, k = 587.3330688476562, 84.31330871582031, 619.0
        rows, state0, kw = [[big, big], [big, c]], (0.0, k), dict(pc=p)
        VC = _rn(f32(0.05) * f32(c))
        score = _rn(np.float64(VC) * np.float64(f32(p)) - k)  # fma(VCc, pc, -Qc)
    x = _rn(f32(0.75) * VC)
    assert _rn(score - np.float64(x) * np.float64(f32(p))) < 0.0
    assert _rn(score - np.float64(_rn(np.float64(x) * np.float64(f32(p))))) == 0.0
    jpol, tpol = JD.SlackThresholdPolicy(V=0.05), PD.SlackThresholdPolicy(V=0.05)
    if guard:
        jpol, tpol = JF.StalenessGuardPolicy(inner=jpol), PF.StalenessGuardPolicy(inner=tpol)
    ref = _crafted(jpol, tpol, 1e7, [1.0, 0.0], rows, dict(deadline=1.0), state0=state0,
                   faults=guard, Pc=1e7, **kw)
    moved = ref.dispatched if side == "edge" else ref.processed
    np.testing.assert_array_equal(np.asarray(moved), [0.0, k])


def test_slack_urgency_is_contracted_in_the_scan():
    """Hazard 32. At slack_scale 10 and slack 7 the urgency's two forms
    differ by an ulp (fma(-7, f32(0.1), 1) = 0.29999998, 1 - 7/10 = 0.3);
    with the crafted intensity the quotient form would put the score
    below 0 and dispatch. JAX does not dispatch: its urgency is the FMA."""
    c, p, k = 510.2671813964844, 6.943140983581543, 124.0
    u_fma = _rn(-7.0 * np.float64(f32(0.1)) + 1.0)
    u_div = _rn(1.0 - np.float64(_rn(7.0 / 10.0)))
    assert (u_fma, u_div) == (f32(0.29999998), f32(0.3))
    VC = _rn(f32(0.05) * f32(c))
    score = _rn(np.float64(VC) * np.float64(f32(p))) - k
    for u, sign in ((u_fma, 1.0), (u_div, -1.0)):
        assert np.sign(_rn(score - np.float64(_rn(u * VC)) * np.float64(f32(p)))) == sign
    ref = _crafted(JD.SlackThresholdPolicy(V=0.05, slack_scale=10.0),
                   PD.SlackThresholdPolicy(V=0.05, slack_scale=10.0), 1e7, [1.0, 0.0],
                   [[1e5, 1e5], [c, 1e5]], dict(deadline=7.0), state0=(k - 1.0, 0.0), pe=p,
                   Pc=1e7)
    np.testing.assert_array_equal(np.asarray(ref.dispatched), [0.0, 0.0])


def test_edd_ties_go_by_index():
    """EDD's edge keys min(slack, 1e6) - (1e6 + 1) tie for every type with
    the same slack: the fill visits them in index order, as JAX's
    top_k does, and the budget binds inside the tie."""
    Mx = 6
    spec = P.NetworkSpec(pe=np.full(Mx, 2.0, f32), pc=np.full((Mx, 2), 1.0, f32), Pe=f32(7.0),
                         Pc=np.full(2, 100.0, f32))
    jspec = J.NetworkSpec(pe=np.full(Mx, 2.0, f32), pc=np.full((Mx, 2), 1.0, f32), Pe=f32(7.0),
                          Pc=np.full(2, 100.0, f32))
    Qe = np.array([1, 3, 0, 2, 5, 1], f32)
    Qc = np.zeros((Mx, 2), f32)
    Qd = np.zeros((Mx, 8), f32)
    Qd[np.arange(Mx), [1, 1, 0, 3, 1, 1]] = Qe
    dl = dict(deadline=np.full(Mx, 4.0, f32))
    jv = JD.deadline_view(JD.make_deadlines(Mx, 8, **dl),
                          JD.DeadlineState(Qd=jnp.asarray(Qd), mu=jnp.zeros(Mx)))
    tv = PD.deadline_view(PD.make_deadlines(Mx, 8, device="cpu", **dl),
                          PD.DeadlineState(Qd=torch.from_numpy(Qd), mu=torch.zeros(Mx)))
    ref = jax.jit(lambda q, v: JD.EDDPolicy()(J.NetworkState(Qe=q, Qc=jnp.asarray(Qc)), jspec,
                                              0.0, jnp.zeros(2), None, deadline_view=v))(
        jnp.asarray(Qe), jv)
    got = PD.EDDPolicy()(P.NetworkState(Qe=torch.from_numpy(Qe), Qc=torch.from_numpy(Qc)), spec,
                         torch.tensor(0.0), torch.zeros(2), deadline_view=tv)
    np.testing.assert_array_equal(got.d.numpy(), np.asarray(ref.d))
    # type 3 (slack 1) first, then the slack-3 tie in index order: type 0
    # takes the last whole item of the budget, types 1, 4 and 5 none
    np.testing.assert_array_equal(got.d.sum(-1).numpy(), [1, 0, 0, 2, 0, 0])


# -------------------------------------------------------------- conservation


@settings(max_examples=8, deadline=None)
@given(d0=st.integers(0, 6), d1=st.sampled_from([np.inf, 1.0, 4.0]), shed=st.booleans(),
       headroom=st.sampled_from([0.5, 0.75, 1.0, 1.25]), p_fail=st.floats(0.0, 1.0, width=32),
       telem=st.floats(0.0, 0.5, width=32), seed=st.integers(0, 2**31 - 1))
def test_conservation_with_expiry_and_shedding(d0, d1, shed, headroom, p_fail, telem, seed):
    """cum(arrived) = Qe + Qc + retry + cum(processed) - cum(failed) +
    cum(missed) + cum(shed), exactly in float32, every slot, for any
    deadlines, shedding and fault stream (bounds exact in float32); the
    rings re-sum to Qe."""
    Mx, Nx = 3, 2
    dl = PD.make_deadlines(Mx, D=8, device="cpu", deadline=np.array([d0, d1, np.inf], f32),
                           window=2.0, shed_on=float(shed), headroom=headroom)
    fp = PF.make_faults(Nx, device="cpu", task_p_fail=p_fail, cloud_p_down=0.1, cloud_p_up=0.5,
                        telem_p_down=telem, telem_p_up=0.5)
    r = P.simulate(PF.StalenessGuardPolicy(PD.SlackThresholdPolicy(V=0.05)), tfs._base(Mx, Nx),
                   P.RandomCarbonSource(N=Nx), P.UniformArrivals(M=Mx), 16, seed, device="cpu",
                   faults=fp, deadlines=dl)
    led = r.deadlines
    held = r.Qe.sum(-1) + r.Qc.sum((-2, -1)) + r.retry.sum((-2, -1))
    np.testing.assert_array_equal(r.backlog.numpy(), held.numpy())
    flow = np.cumsum(r.arrived.numpy()) - np.cumsum(r.processed.numpy()) + np.cumsum(
        r.failed.numpy()) - np.cumsum(led.missed.numpy()) - np.cumsum(led.shed.numpy())
    np.testing.assert_array_equal(r.backlog.numpy(), flow.astype(f32))
    np.testing.assert_array_equal((led.admitted + led.shed).numpy(), r.arrived.numpy())
    assert torch.equal(led.Qd.sum(-1), r.Qe)


# ------------------------------------------------------------------- serving


class _Clock:
    """Integer-second ticks, so latencies are exact."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1
        return float(self.t)


@pytest.mark.parametrize("shed", [0.0, 1.0])
def test_serve_with_deadlines_equals_batch_and_jax(shed, tmp_path):
    """The served trajectory is the batch one bitwise (queues, rings,
    emissions), and the ServeReport's deadline fields are JAX's
    `serve_loop`'s under the same injected clock."""
    steps = 32
    kw = dict(deadline=2.0, shed_on=shed, headroom=0.9)
    pol = PD.SlackThresholdPolicy(V=0.05)
    arr = torch.from_numpy(ARRIVALS)
    rep = tserve.serve_loop(pol, tfs._base(M, N), P.TableCarbonSource(table=TABLE),
                            lambda t, key, device: arr[t], steps, 1, clock=_Clock(),
                            outdir=tmp_path, stem="dl", flush_every=8, device="cpu",
                            deadlines=PD.make_deadlines(M, device="cpu", **kw))
    res = _port_run(pol, PD.make_deadlines(M, device="cpu", **kw), T=steps)
    backlog = np.array([float(res.Qe[t].sum() + res.Qc[t].sum()) for t in range(steps)])
    np.testing.assert_array_equal(rep.backlog, backlog)
    np.testing.assert_array_equal(rep.emissions, res.emissions.numpy())
    assert torch.equal(rep.state.Qe, res.Qe[-1]) and torch.equal(rep.state.Qc, res.Qc[-1])
    assert torch.equal(rep.dstate.Qd, res.deadlines.Qd[-1])
    assert rep.missed_total == float(res.deadlines.missed.double().sum())
    assert rep.shed_total == float(res.deadlines.shed.double().sum())
    jarr = jnp.asarray(ARRIVALS)
    ref = jserve.serve_loop(JD.SlackThresholdPolicy(V=0.05), jfs._base(M, N),
                            J.TableCarbonSource(table=TABLE), lambda t, k: jarr[t], steps,
                            jax.random.PRNGKey(1), clock=_Clock(),
                            deadlines=JD.make_deadlines(M, **kw))
    for name in ("tasks_arrived", "tasks_dispatched", "tasks_processed", "missed_total",
                 "shed_total", "age_p50", "age_p95", "age_p99", "age_over_deadline_frac",
                 "max_queue_age", "p50_us", "p99_us", "wall_s"):
        assert getattr(rep, name) == getattr(ref, name), name
    np.testing.assert_array_equal(rep.queue_age, ref.queue_age)
    np.testing.assert_allclose(rep.total_emissions, ref.total_emissions, rtol=1e-6)
    assert rep.missed_total + rep.shed_total > 0
    events = [json.loads(line) for line in (tmp_path / "dl.jsonl").read_text().splitlines()]
    assert sum(e["missed"] for e in events if e["event"] == "slot") == rep.missed_total
    assert events[-1]["shed_total"] == rep.shed_total
    assert "repro_serve_missed_total" in (tmp_path / "dl.prom").read_text()


def test_serve_cli_deadline_shed_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_SMOKE", "1")
    rep = tserve.main(["--device", "cpu", "--slots", "12", "--types", "32", "--clouds", "3",
                       "--deadline", "4", "--shed"])
    out = capsys.readouterr().out
    assert "missed" in out and "shed" in out and rep.slots == 12


# --------------------------------------------------------- conversion, refusal


def test_deadlines_from_reference_and_stacking():
    jp = JD.make_deadlines(4, 12, deadline=[1.0, np.inf, 3.0, 11.0], shed_on=1.0, alpha=0.4)
    tp = convert.deadlines_from_reference(jp, device="cpu")
    for name in PD.DeadlineParams._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    stacked = PD.stack_deadlines([tp, tp, tp])
    assert stacked.deadline.shape == (3, 4) and stacked.alpha.shape == (3,) and stacked.D == 12


def test_telemetry_still_refused():
    """The telemetry layer, once refused, is taken by the deadline loops,
    plain and faulted: the probe's missed and shed are the ledger's."""
    from repro_torch.telemetry import TelemetryConfig

    for kw in ({}, dict(faults=PF.no_faults(N, device="cpu"))):
        res = P.simulate(P.CarbonIntensityPolicy(), tfs._base(M, N),
                         P.TableCarbonSource(table=TABLE), P.UniformArrivals(M=M), 4,
                         device="cpu", telemetry=TelemetryConfig(), deadlines=_dl("port"), **kw)
        assert torch.equal(res.telemetry.missed, res.deadlines.missed)
        assert torch.equal(res.telemetry.shed, res.deadlines.shed)
        assert float(res.telemetry.conservation_residual.abs().max()) == 0.0


def test_deadline_entry_points_default_to_cuda():
    """Without a card every constructor and loop raises unless passed
    device="cpu": nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    for call in (lambda: PD.no_deadlines(M), lambda: PD.make_deadlines(M, deadline=2.0),
                 lambda: PD.init_deadlines(M, 8),
                 lambda: PD.make_deadlines(M, device="cpu").to("cuda"),
                 lambda: tserve.serve_loop(PD.SlackThresholdPolicy(), tfs._base(M, N),
                                           P.TableCarbonSource(table=TABLE), P.UniformArrivals(M=M),
                                           2, deadlines=PD.make_deadlines(M, device="cpu"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
