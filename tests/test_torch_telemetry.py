"""The port's telemetry layer (`repro_torch.telemetry`) against the JAX
package's `repro.telemetry`.

Every anchor of `tests/test_telemetry.py` has its twin here, on its four
kinds of run (plain, WAN, faulted, WAN-faulted) at its sizes (M4 x N3,
T=48, PRNGKey(42)):

* the port's Telemetry frame is JAX's: every field bitwise, dtypes
  included (staleness and the alert records int32), but the emission
  series and its total, which carry the emissions' rtol 1e-6 (the
  result's own `emissions` field is held so everywhere);
* taps on leave every other result field bitwise; the frame is bitwise
  the same in every record mode; the conservation residual is exactly 0;
* each monitor fires exactly where hand-built probe series say, through
  the plain per-slot step and the tap kernel's plain version alike, and
  on deterministic fault runs;
* fleet lanes (plain, WAN, fault and deadline lanes) are bitwise their
  instances run alone, and a fleet's frame is JAX's vmapped frame;
* the exporters give JAX's strings byte for byte on the same frame, and
  the validators accept them and reject garbage;
* `manifest` of the SMOKE `bench_telemetry_overhead` fleet and of the
  SMOKE fault rows equals jax 0.9.0's, and chip_smoke.py's TELEMETRY_JAX,
  FAULT_MANIFEST_JAX and STREAM_JAX anchors are jax 0.9.0's;
* with taps on, `simulate`'s loop adds at most 10 non-view aten ops a
  slot (a TorchDispatchMode counter; the tap scan after the loop is not
  the loop's).
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.deadlines as JD  # noqa: E402
import repro.faults as JF  # noqa: E402
import repro.network as JN  # noqa: E402
import repro.telemetry as JT  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.deadlines as PD  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
import repro_torch.network as PN  # noqa: E402
import repro_torch.telemetry as PT  # noqa: E402
from repro.configs import fleet_scenarios as jfs  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.taps import TapOut, tap_scan_plain  # noqa: E402

T = 48
M, N = 4, 3
KINDS = ["plain", "wan", "faulted", "wan-faulted"]
K = len(PT.MONITORS)
# the fields that carry the emissions' rtol (every other one is bitwise;
# fault lanes add the waste, which the fault tests hold so too)
EMISSION_FIELDS = ("emission_rate", "total_emissions")


def _jax_run(kind, telemetry=JT.TelemetryConfig(), record="full"):
    kw = {}
    if kind in ("wan", "wan-faulted"):
        pol = JN.NetworkAwareDPPPolicy(V=0.05)
        kw["graph"] = JN.star_graph(M, N, np.random.default_rng(7))
        if kind == "wan-faulted":
            kw["faults"] = JF.make_faults(N, kw["graph"].L, task_p_fail=0.1, link_p_down=0.2,
                                          link_p_up=0.5, link_floor=0.0)
    else:
        pol = J.CarbonIntensityPolicy(V=0.05)
        if kind == "faulted":
            kw["faults"] = JF.make_faults(N, task_p_fail=0.1, cloud_p_down=0.1, cloud_p_up=0.5,
                                          telem_p_down=0.1, telem_p_up=0.5)
    return J.simulate(pol, jfs._base(M, N), J.RandomCarbonSource(N=N), J.UniformArrivals(M=M),
                      T, jax.random.PRNGKey(42), telemetry=telemetry, record=record, **kw)


def _run(kind, telemetry=None, record="full"):
    """tests/test_telemetry.py's run of each kind, in the port."""
    kw = {}
    if kind in ("wan", "wan-faulted"):
        pol = PN.NetworkAwareDPPPolicy(V=0.05)
        kw["graph"] = PN.star_graph(M, N, np.random.default_rng(7))
        if kind == "wan-faulted":
            kw["faults"] = PF.make_faults(N, kw["graph"].L, device="cpu", task_p_fail=0.1,
                                          link_p_down=0.2, link_p_up=0.5, link_floor=0.0)
    else:
        pol = P.CarbonIntensityPolicy(V=0.05)
        if kind == "faulted":
            kw["faults"] = PF.make_faults(N, device="cpu", task_p_fail=0.1, cloud_p_down=0.1,
                                          cloud_p_up=0.5, telem_p_down=0.1, telem_p_up=0.5)
    return P.simulate(pol, tfs._base(M, N), P.RandomCarbonSource(N=N), P.UniformArrivals(M=M),
                      T, 42, device="cpu", telemetry=telemetry, record=record, **kw)


def assert_frame_matches_jax(got, ref, loose=EMISSION_FIELDS):
    """Every field of the port's frame bitwise JAX's, dtype and shape
    included; the emission fields within rtol 1e-6."""
    for name in PT.Telemetry._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape)
        if name in loose:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_frames_equal(a, b):
    for name, x, y in zip(PT.Telemetry._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


# -------------------------------------------------------- parity anchors


@pytest.mark.parametrize("kind", KINDS)
def test_frame_matches_jax(kind):
    got = _run(kind, PT.TelemetryConfig())
    ref = _jax_run(kind)
    assert_frame_matches_jax(got.telemetry, ref.telemetry)
    assert got.telemetry.staleness.dtype == torch.int32
    assert got.telemetry.alert_first_slot.dtype == torch.int32


def test_telemetry_defaults_to_none():
    assert _run("plain").telemetry is None
    fleet = tfs.build_fleet(["diurnal-slack"], per_kind=1, M=M, N=N, Tc=24, seed=0, device="cpu")
    assert P.simulate_fleet(P.CarbonIntensityPolicy(), fleet, 12, 0, record="summary",
                            device="cpu").telemetry is None


@pytest.mark.parametrize("kind", KINDS)
def test_taps_on_leaves_base_fields_bitwise(kind):
    """The taps observe, never steer: every field the telemetry=None
    result carries is bitwise unchanged, and taps off launch nothing."""
    ops.reset_launch_counts()
    r0 = _run(kind)
    r1 = _run(kind, PT.TelemetryConfig())
    assert r0.telemetry is None and r1.telemetry is not None
    for name in type(r0)._fields:
        if name != "telemetry" and getattr(r0, name) is not None:
            assert torch.equal(getattr(r0, name), getattr(r1, name)), (kind, name)
    if kind in ("faulted", "wan-faulted"):
        assert r1.stale.dtype == torch.float32
        assert torch.equal(r1.stale, r1.telemetry.staleness.float())


@pytest.mark.parametrize("kind", KINDS)
def test_frame_bitwise_equal_across_record_modes(kind):
    full = _run(kind, PT.TelemetryConfig(), record="full").telemetry
    _assert_frames_equal(full, _run(kind, PT.TelemetryConfig(), record="summary").telemetry)
    _assert_frames_equal(full, _run(kind, PT.TelemetryConfig(), record=4).telemetry)


@pytest.mark.parametrize("kind", KINDS)
def test_conservation_residual_exactly_zero(kind):
    tel = _run(kind, PT.TelemetryConfig()).telemetry
    assert float(tel.conservation_residual.abs().max()) == 0.0
    k = PT.MONITORS.index("conservation_drift")
    assert int(tel.alert_tripped[k]) == 0 and int(tel.alert_first_slot[k]) == -1


# ------------------------------------------------------------ tap math


def _probe(backlog=0.0, arrived=0.0, processed=0.0, failed=0.0, stale=0, clouds_down=0.0,
           missed=0.0, shed=0.0):
    f = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    return PT.TelemetryProbe(
        emissions=f(1.0), arrived=f(arrived), dispatched=torch.zeros(N), processed=f(processed),
        failed=f(failed), wasted=f(0.0), backlog=f(backlog),
        stale=torch.tensor(stale, dtype=torch.int32), clouds_down=f(clouds_down),
        retry_depth=f(0.0), transfer_occupancy=f(0.0), missed=f(missed), shed=f(shed))


def _run_taps(cfg, probes):
    """The probes through the plain per-slot step and `finalize_taps`,
    and through the kernel's plain version over the stacked series: the
    two frames must be bitwise equal; returns the first."""
    tap, rows = PT.init_taps(device="cpu"), []
    for p in probes:
        tap, row = PT.step_taps(cfg, tap, p)
        rows.append(row)
    tel = PT.finalize_taps(cfg, PT.TapSeries(*(torch.stack(xs) for xs in zip(*rows))))
    series = PT.TelemetryProbe(*(torch.stack(xs, dim=-1 if xs[0].dim() == 0 else -2)
                                 for xs in zip(*probes)))
    out, state = TapOut.empty((), len(probes), "cpu"), torch.zeros(7)
    tap_scan_plain(cfg, series, out, state, 0, len(probes))
    _assert_frames_equal(tel, out.frame(series))
    return tel


def _alert(tel, monitor):
    k = PT.MONITORS.index(monitor)
    return int(tel.alert_tripped[k]), int(tel.alert_first_slot[k]), int(tel.alert_count[k])


CFG = PT.TelemetryConfig()


def test_backlog_growth_monitor_needs_sustained_growth():
    cfg = dataclasses.replace(CFG, growth_sustain=3)
    tel = _run_taps(cfg, [_probe(backlog=float(i + 1), arrived=1.0) for i in range(8)])
    assert _alert(tel, "backlog_growth") == (1, 2, 6)
    levels = [1.0, 2.0, 2.0, 3.0, 4.0, 5.0]
    deltas = [levels[0]] + [b - a for a, b in zip(levels, levels[1:])]
    tel = _run_taps(cfg, [_probe(backlog=b, arrived=d) for b, d in zip(levels, deltas)])
    assert _alert(tel, "backlog_growth") == (1, 5, 1)


def test_staleness_monitor_threshold():
    tel = _run_taps(CFG, [_probe(stale=i) for i in range(10)])
    assert _alert(tel, "signal_staleness") == (1, CFG.stale_budget + 1,
                                               10 - CFG.stale_budget - 1)
    tel = _run_taps(CFG, [_probe(stale=CFG.stale_budget)] * 6)
    assert _alert(tel, "signal_staleness") == (0, -1, 0)


def test_all_clouds_down_monitor():
    tel = _run_taps(CFG, [_probe(clouds_down=float(N - 1))] * 3 + [_probe(clouds_down=float(N))] * 2)
    assert _alert(tel, "all_clouds_down") == (1, 3, 2)


def test_conservation_drift_monitor():
    tel = _run_taps(CFG, [_probe(arrived=1.0)] * 4)
    assert _alert(tel, "conservation_drift") == (1, 0, 4)
    tel = _run_taps(CFG, [_probe(arrived=2.0, backlog=1.0, processed=1.0),
                          _probe(arrived=2.0, backlog=2.0, processed=1.0)])
    assert _alert(tel, "conservation_drift") == (0, -1, 0)
    # drift_tol 0.5: a residual of exactly 0.5 does not fire, the next float up does
    half = float(np.nextafter(np.float32(0.5), np.float32(1.0)))
    tel = _run_taps(CFG, [_probe(arrived=0.5), _probe(arrived=half - 0.5)])
    assert _alert(tel, "conservation_drift") == (1, 1, 1)


def test_deadline_miss_and_shed_rate_monitors():
    cfg = dataclasses.replace(CFG, miss_tol=2.0, shed_frac=0.25)
    tel = _run_taps(cfg, [_probe(arrived=8.0, missed=2.0, shed=2.0, backlog=4.0),
                          _probe(arrived=8.0, missed=3.0, shed=2.5, backlog=8.0 - 3.0 - 2.5 + 4.0)])
    assert _alert(tel, "deadline_miss") == (1, 1, 1)
    assert _alert(tel, "shed_rate") == (1, 1, 1)
    # deadline-off residual: missed and shed +0.0, the residual's bits unchanged
    tel = _run_taps(CFG, [_probe(arrived=3.0, backlog=3.0)])
    assert float(tel.conservation_residual[0]) == 0.0
    assert not torch.signbit(tel.conservation_residual[0])


def _threshold_rows(case):
    """One-slot runs that put one monitor one float below, at and one
    float above its threshold (growth_thresh 0.1, stale_budget 3, all N
    clouds down, drift_tol 0.3, miss_tol 0.7, shed_frac 0.1 of 10
    arrivals): the slot's row in each."""
    f = np.float32
    near = [float(np.nextafter(f(v), f(-np.inf))) for v in (0.1, 0.3, 0.7, 1.0)], \
        [float(f(v)) for v in (0.1, 0.3, 0.7, 1.0)], \
        [float(np.nextafter(f(v), f(np.inf))) for v in (0.1, 0.3, 0.7, 1.0)]
    base = dict(backlog=0.0, arrived=0.0, processed=0.0, failed=0.0, stale=0, clouds_down=0.0,
                missed=0.0, shed=0.0)
    out = []
    for i, (g, d, m, sh) in enumerate(near):
        out.append(dict(base, **{
            "growth": dict(backlog=g), "stale": dict(stale=2 + i),
            "down": dict(clouds_down=float(N - 1 + min(i, 1))), "drift": dict(arrived=d),
            "miss": dict(missed=m), "shed": dict(arrived=10.0, shed=sh)}[case]))
    return out


@pytest.mark.parametrize("case", ["growth", "stale", "down", "drift", "miss", "shed"])
def test_monitor_thresholds_match_jax(case):
    """Each monitor near its threshold, through JAX's step_taps scan and
    finalize_taps under jit and the port's plain step and kernel: the
    whole frame bitwise."""
    cfg = dict(growth_thresh=0.1, growth_sustain=1, stale_budget=3, drift_tol=0.3, miss_tol=0.7,
               shed_frac=0.1)
    k = ("growth", "stale", "down", "drift", "miss", "shed").index(case)
    jcfg, pcfg = JT.TelemetryConfig(**cfg), PT.TelemetryConfig(**cfg)

    def jprobe(r):
        return JT.TelemetryProbe(
            emissions=jnp.float32(1.0), arrived=jnp.float32(r["arrived"]),
            dispatched=jnp.zeros((N,), jnp.float32), processed=jnp.float32(r["processed"]),
            failed=jnp.float32(r["failed"]), wasted=jnp.float32(0.0),
            backlog=jnp.float32(r["backlog"]), stale=jnp.int32(r["stale"]),
            clouds_down=jnp.float32(r["clouds_down"]), retry_depth=jnp.float32(0.0),
            transfer_occupancy=jnp.float32(0.0), missed=jnp.float32(r["missed"]),
            shed=jnp.float32(r["shed"]))

    scan = jax.jit(lambda ps: JT.finalize_taps(jcfg, jax.lax.scan(
        lambda tap, p: JT.step_taps(jcfg, tap, p), JT.init_taps(), ps)[1]))
    fired = []
    for row in _threshold_rows(case):
        ref = scan(jax.tree.map(lambda x: x[None], jprobe(row)))
        got = _run_taps(pcfg, [_probe(**row)])
        assert_frame_matches_jax(got, ref, loose=())
        fired.append(int(got.alert_active[0, k]))
    assert fired == ([0, 1, 1] if case == "down" else [0, 0, 1]), fired


# ------------------------------------------ monitors on real fault runs


def test_staleness_trips_under_dead_carbon_feed():
    cfg = dataclasses.replace(CFG, stale_budget=2)
    res = P.simulate(P.CarbonIntensityPolicy(V=0.05), tfs._base(M, N), P.RandomCarbonSource(N=N),
                     P.UniformArrivals(M=M), T, 42, device="cpu", telemetry=cfg,
                     faults=PF.make_faults(N, device="cpu", telem_p_down=1.0, telem_p_up=0.0))
    assert _alert(res.telemetry, "signal_staleness") == (1, 2, T - 2)
    np.testing.assert_array_equal(res.telemetry.staleness.numpy(), np.arange(1, T + 1))


def test_all_clouds_down_trips_under_total_blackout():
    res = P.simulate(P.CarbonIntensityPolicy(V=0.05), tfs._base(M, N), P.RandomCarbonSource(N=N),
                     P.UniformArrivals(M=M), T, 42, device="cpu", telemetry=CFG,
                     faults=PF.make_faults(N, device="cpu", sched_start=0.0, sched_len=float(T)))
    assert _alert(res.telemetry, "all_clouds_down") == (1, 0, T)
    assert float(res.telemetry.clouds_down.min()) == N


def test_deadline_run_feeds_missed_and_shed():
    """A deadline run's probe carries the ledger's missed and shed series
    (the same tensors), its residual stays 0, and JAX's frame is the
    port's."""
    table = np.asarray(J.carbon.diurnal_table(96, N, np.random.default_rng(3)))
    arrivals = np.random.default_rng(4).integers(0, 700, (T, M)).astype(np.float32)
    kw = dict(deadline=np.array([2, 3, 1, 5], np.float32), shed_on=1.0, headroom=0.7, alpha=0.3)
    arr = jnp.asarray(arrivals)
    ref = jax.jit(lambda d, k: J.simulate(
        JD.SlackThresholdPolicy(V=0.2), jfs._base(M, N), J.TableCarbonSource(table=table),
        lambda t, kk: arr[t % T], T, k, deadlines=d, telemetry=JT.TelemetryConfig()))(
            JD.make_deadlines(M, **kw), jax.random.PRNGKey(1))
    a = torch.from_numpy(arrivals)
    got = P.simulate(PD.SlackThresholdPolicy(V=0.2), tfs._base(M, N),
                     P.TableCarbonSource(table=table), lambda t, key, device: a[t % T], T, 1,
                     device="cpu", deadlines=PD.make_deadlines(M, device="cpu", **kw),
                     telemetry=PT.TelemetryConfig())
    tel = got.telemetry
    assert tel.missed is got.deadlines.missed and tel.shed is got.deadlines.shed
    assert float(tel.total_missed) > 0 and float(tel.total_shed) > 0
    assert float(tel.conservation_residual.abs().max()) == 0.0
    assert_frame_matches_jax(tel, ref.telemetry)


# --------------------------------------------------------------- fleets


def _solo(pol, fleet, f, T, key, **kw):
    spec = P.NetworkSpec(*(torch.as_tensor(x[f]) for x in fleet.spec))
    if fleet.graph is not None:
        kw["graph"] = PN.LinkGraph(*(x[f] for x in fleet.graph))
    if fleet.faults is not None:
        kw["faults"] = PF.FaultParams(*(None if x is None else x[f] for x in fleet.faults))
    if fleet.deadlines is not None:
        kw["deadlines"] = PD.DeadlineParams(*(x[f] for x in fleet.deadlines))
    return P.simulate(pol, spec, P.TableCarbonSource(table=fleet.carbon[f]),
                      P.FleetArrivals(amax=fleet.arrival_amax[f]), T, key, device="cpu",
                      telemetry=CFG, **kw)


@pytest.mark.parametrize("layers", ["plain", "wan", "faults", "deadlines", "wan+faults+deadlines"])
def test_fleet_lanes_equal_solo_runs(layers):
    """simulate_fleet stacks a whole frame a lane ([F, ...] fields); lane
    f is bitwise the frame of its instance run alone, whatever layers
    the lanes carry."""
    wan = "wan" in layers
    if wan:
        fleet = tfs.build_network_fleet(["congested-uplink"], per_kind=2, M=M, N=N, Tc=24,
                                        seed=0, device="cpu")
        pol = PN.NetworkAwareDPPPolicy(V=0.05)
    else:
        fleet = tfs.build_fleet(["diurnal-slack", "overload"], per_kind=1, M=M, N=N, Tc=24,
                                seed=0, device="cpu")
        pol = P.CarbonIntensityPolicy(V=0.05)
    if "faults" in layers:
        fleet = tfs.with_faults(fleet, "flappy-uplink" if wan else "regional-blackout", seed=3)
    if "deadlines" in layers:
        fleet = tfs.with_deadlines(fleet, "shed-overload", seed=2)
    Tf = 24
    res = P.simulate_fleet(pol, fleet, Tf, 5, record="summary", device="cpu", telemetry=CFG)
    tel = res.telemetry
    assert tel.backlog.shape == (fleet.F, Tf) and tel.alert_active.shape == (fleet.F, Tf, K)
    assert tel.alert_first_slot.shape == (fleet.F, K) and tel.peak_backlog.shape == (fleet.F,)
    keys = R.split(R.PRNGKey(5, device="cpu"), fleet.F)
    for f in range(fleet.F):
        _assert_frames_equal(PT.lane(tel, f), _solo(pol, fleet, f, Tf, keys[f]).telemetry)
    man = PT.manifest(tel)
    assert man["peak_backlog"] == float(tel.peak_backlog.max()) and set(man["alerts"]) == set(
        PT.MONITORS)


def test_fleet_frame_matches_jax_vmap():
    """A fleet with fault and deadline lanes against JAX's vmapped
    simulate_fleet (the fleet an argument of the jitted run)."""
    jfl = jfs.with_deadlines(jfs.with_faults(jfs.build_fleet(
        ["diurnal-slack", "overload"], per_kind=2, M=6, N=4, Tc=24, seed=0),
        "regional-blackout", seed=1), "tight-uniform", seed=1)
    tfl = tfs.with_deadlines(tfs.with_faults(tfs.build_fleet(
        ["diurnal-slack", "overload"], per_kind=2, M=6, N=4, Tc=24, seed=0, device="cpu"),
        "regional-blackout", seed=1), "tight-uniform", seed=1)
    ref = jax.jit(lambda fl, k: J.simulate_fleet(
        JF.StalenessGuardPolicy(inner=J.CarbonIntensityPolicy(V=0.05)), fl, 24, k,
        record="summary", telemetry=JT.TelemetryConfig()))(jfl, jax.random.PRNGKey(0))
    got = P.simulate_fleet(PF.StalenessGuardPolicy(inner=P.CarbonIntensityPolicy(V=0.05)), tfl,
                           24, 0, record="summary", device="cpu", telemetry=CFG)
    assert_frame_matches_jax(got.telemetry, ref.telemetry,
                             loose=EMISSION_FIELDS + ("wasted", "total_wasted"))
    assert float(got.telemetry.total_failed.sum()) > 0 and float(got.telemetry.total_missed.sum()) > 0


# ------------------------------------------------------------- exporters


@pytest.fixture(scope="module")
def frames():
    """JAX's faulted frame and the same values as a port frame."""
    ref = _jax_run("faulted").telemetry
    return ref, PT.Telemetry(*(torch.from_numpy(np.array(x)) for x in ref))


def test_exporters_byte_equal_to_jax(frames):
    ref, got = frames
    assert PT.to_prometheus(got) == JT.to_prometheus(ref)
    assert PT.to_jsonl(got) == JT.to_jsonl(ref)
    assert PT.to_chrome_trace(got) == JT.to_chrome_trace(ref)
    fleet_ref = jax.tree.map(lambda x: jnp.stack([x, x]), ref)
    fleet_got = PT.Telemetry(*(torch.stack([x, x]) for x in got))
    assert PT.manifest(fleet_got) == JT.manifest(fleet_ref)
    assert json.dumps(PT.manifest(got)) == json.dumps(JT.manifest(ref))


def test_exporters_roundtrip_their_validators(frames):
    _, frame = frames
    assert PT.validate_prometheus(PT.to_prometheus(frame)) > 10
    assert PT.validate_jsonl(PT.to_jsonl(frame)) >= T + 1
    assert PT.validate_chrome_trace(PT.to_chrome_trace(frame)) > T


def test_exporters_reject_fleet_frames(frames):
    _, frame = frames
    fleet_frame = PT.Telemetry(*(torch.stack([x, x]) for x in frame))
    with pytest.raises(ValueError, match="lane"):
        PT.to_prometheus(fleet_frame)
    assert PT.manifest(fleet_frame)["alerts"]


def test_write_run_and_validate_dir(frames, tmp_path):
    _, frame = frames
    paths = PT.write_run(frame, tmp_path, stem="t")
    counts = PT.validate_dir(tmp_path)
    assert set(map(str, paths.values())) == set(counts)
    jax_text = {"prometheus": JT.to_prometheus, "jsonl": JT.to_jsonl,
                "chrome_trace": JT.to_chrome_trace}
    for fmt, p in paths.items():
        assert p.read_text() == jax_text[fmt](frames[0]), fmt
    with pytest.raises(ValueError, match="no .*files"):
        PT.validate_dir(tmp_path / "empty")
    with pytest.raises(ValueError, match="unknown formats"):
        PT.validate_dir(tmp_path, formats=("csv",))


def test_validators_reject_garbage():
    for bad in ("repro_thing 1.0\n", "# HELP\n", "# TYPE x gauge\nx one\n", ""):
        with pytest.raises(ValueError):
            PT.validate_prometheus(bad)
    with pytest.raises(ValueError):
        PT.validate_jsonl('{"event": "slot"}\n')
    with pytest.raises(ValueError):
        PT.validate_jsonl('{"t": 1}\n')
    with pytest.raises(ValueError):
        PT.validate_chrome_trace('{"traceEvents": []}')
    with pytest.raises(ValueError):
        PT.validate_chrome_trace('{"traceEvents": [{"ph": "C", "name": "x"}]}')


def test_oracle_gap_series_matches_jax():
    table = np.asarray(J.carbon.diurnal_table(T, N, np.random.default_rng(3)))
    got = P.simulate(P.CarbonIntensityPolicy(V=0.05), tfs._base(M, N),
                     P.TableCarbonSource(table=table), P.UniformArrivals(M=M), T, 42,
                     device="cpu", telemetry=CFG)
    ref = J.simulate(J.CarbonIntensityPolicy(V=0.05), jfs._base(M, N),
                     J.TableCarbonSource(table), J.UniformArrivals(M=M), T,
                     jax.random.PRNGKey(42), telemetry=JT.TelemetryConfig())
    for horizon in (1, 8, None):
        o, g = PT.oracle_gap_series(got, table, horizon=horizon)
        jo, jg = JT.oracle_gap_series(ref, table, horizon=horizon)
        np.testing.assert_allclose(o, jo, rtol=1e-6)
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-3 * float(np.abs(jo).max()))


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with PT.trace_to(tmp_path / "prof"):
        _run("plain", CFG)
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert doc["traceEvents"]


# ------------------------------------------------ manifests against JAX


def _smoke_fleet(jaxside):
    fs = jfs if jaxside else tfs
    kw = {} if jaxside else {"device": "cpu"}
    return fs.build_fleet(["diurnal-slack"], per_kind=4, Tc=96, seed=0, **kw)


def test_smoke_telemetry_overhead_manifest_matches_jax():
    """bench_telemetry_overhead at its SMOKE size (diurnal-slack x 4, T=48,
    CarbonIntensity(V=0.05), summary): taps-off fields bitwise, and the
    manifest JAX's (the emission total within rtol 1e-6)."""
    ref = jax.jit(lambda fl, k: J.simulate_fleet(J.CarbonIntensityPolicy(V=0.05), fl, 48, k,
                                                 record="summary",
                                                 telemetry=JT.TelemetryConfig()))(
        _smoke_fleet(True), jax.random.PRNGKey(0))
    pol = P.CarbonIntensityPolicy(V=0.05)
    off = P.simulate_fleet(pol, _smoke_fleet(False), 48, 0, record="summary", device="cpu")
    on = P.simulate_fleet(pol, _smoke_fleet(False), 48, 0, record="summary", device="cpu",
                          telemetry=CFG)
    for name in type(off)._fields:
        if getattr(off, name) is not None:
            assert torch.equal(getattr(off, name), getattr(on, name)), name
    assert_manifest(PT.manifest(on.telemetry), JT.manifest(ref.telemetry))


def assert_manifest(got, want, rtol=1e-6):
    """Alert records and the peak exactly, the totals within rtol."""
    assert got["alerts"] == want["alerts"] and got["peak_backlog"] == want["peak_backlog"]
    for k in ("total_emissions", "total_wasted", "total_failed"):
        assert got[k] == pytest.approx(want[k], rel=rtol, abs=0.0), k


def _fault_policies(pname, wan, jaxside, V=0.05):
    C, N_, F_ = (J, JN, JF) if jaxside else (P, PN, PF)
    if wan:
        aware = N_.NetworkAwareDPPPolicy(V=V)
        return {"qlen": N_.StaticRoutePolicy(C.QueueLengthPolicy()), "carbon": aware,
                "guard": F_.StalenessGuardPolicy(inner=aware)}[pname]
    ci = C.CarbonIntensityPolicy(V=V)
    return {"qlen": C.QueueLengthPolicy(), "carbon": ci,
            "guard": F_.StalenessGuardPolicy(inner=ci)}[pname]


def _fault_fleet(scen, per_kind, jaxside):
    fs = jfs if jaxside else tfs
    kw = {} if jaxside else {"device": "cpu"}
    if scen == "flappy-uplink":
        flt = fs.build_network_fleet(["congested-uplink"], per_kind=per_kind, Tc=96, seed=0, **kw)
    else:
        flt = fs.build_fleet(["diurnal-slack"], per_kind=per_kind, Tc=96, seed=0, **kw)
    return fs.with_faults(flt, scen, seed=0)


@pytest.mark.parametrize("scen,pname", [("regional-blackout", "guard"),
                                        ("telemetry-brownout", "guard"),
                                        ("flappy-uplink", "guard"), ("flappy-uplink", "qlen")])
def test_smoke_fault_row_manifests_match_jax(scen, pname):
    """bench_fault_robustness's rows at their SMOKE size (per_kind=4,
    T=48): the taps-on rerun's manifest, as the bench stamps it (the
    guard on each scenario, and the WAN baseline's static routes; the
    pinned anchors below cover all nine rows at full size)."""
    wan = scen == "flappy-uplink"
    jpol = _fault_policies(pname, wan, True)
    ref = jax.jit(lambda fl, k: J.simulate_fleet(jpol, fl, 48, k, record="summary",
                                                 telemetry=JT.TelemetryConfig()))(
        _fault_fleet(scen, 4, True), jax.random.PRNGKey(0))
    got = P.simulate_fleet(_fault_policies(pname, wan, False), _fault_fleet(scen, 4, False), 48, 0,
                           record="summary", device="cpu", telemetry=CFG)
    assert_manifest(PT.manifest(got.telemetry), JT.manifest(ref.telemetry))
    assert_frame_matches_jax(got.telemetry, ref.telemetry, loose=EMISSION_FIELDS + (
        "wasted", "total_wasted"))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_telemetry_anchors_pinned():
    """chip_smoke.py phase 4h's anchors are jax 0.9.0's manifests, the
    fleet an argument of the jitted run: TELEMETRY_JAX
    (bench_telemetry_overhead, F32, T=192), FAULT_MANIFEST_JAX (the nine
    bench_fault_robustness rows, F16, T=192, and W1's congested-uplink
    fleet under NetworkAwareDPP, F64, T=192, record=T//8) and STREAM_JAX
    (bench_stream_overhead's instance, M2048 x N64, T=192)."""
    cs = _chip_smoke()
    key = jax.random.PRNGKey(0)
    tcfg = JT.TelemetryConfig()

    def fleet_manifest(pol, flt, T, record="summary"):
        return cs.manifest_row(JT.manifest(jax.jit(lambda fl, k: J.simulate_fleet(
            pol, fl, T, k, record=record, telemetry=tcfg))(flt, key).telemetry))

    assert fleet_manifest(J.CarbonIntensityPolicy(V=cs.V_FAULT), jfs.build_fleet(
        ["diurnal-slack"], per_kind=cs.TEL_PER_KIND, Tc=96, seed=0), cs.T_TEL) == cs.TELEMETRY_JAX
    for row, want in cs.FAULT_MANIFEST_JAX.items():
        if row == "W1 congested-uplink aware":
            flt = jfs.build_network_fleet(["congested-uplink"], per_kind=cs.W1_PER_KIND, Tc=96,
                                          seed=0)
            got = fleet_manifest(JN.NetworkAwareDPPPolicy(V=cs.V_WAN), flt, cs.T_W1,
                                 record=cs.T_W1 // 8)
        else:
            scen, pname = row.split("/")
            got = fleet_manifest(_fault_policies(pname, scen == "flappy-uplink", True,
                                                 V=cs.V_FAULT),
                                 _fault_fleet(scen, cs.FAULT_PER_KIND, True), cs.T_FAULT)
        assert got == want, row
    spec = J.NetworkSpec(*cs.stream_instance_arrays())
    ref = jax.jit(lambda k: J.simulate(
        J.CarbonIntensityPolicy(V=cs.V_FAULT), spec, J.UKRegionalTraceSource(N=cs.N_STREAM),
        J.UniformArrivals(M=cs.M_STREAM, amax=cs.A_STREAM), cs.T_STREAM, k, record="summary",
        telemetry=tcfg))(key)
    assert cs.manifest_row(JT.manifest(ref.telemetry)) == cs.STREAM_JAX


# -------------------------------------------------------------- the loop's cost


def test_taps_add_few_aten_ops_a_slot(monkeypatch):
    """Non-view aten ops that taps on add to `simulate`'s loop a slot,
    counted by a TorchDispatchMode over runs of 16 and 32 slots (the
    difference of the two cancels what a run adds once, such as the
    tape's buffers); the tap scan after the loop is not counted, and the
    probe's sums count as the one op they are on the card (one
    `tap_probe` launch a slot; the plain version's XLA-order adds are
    not the card's cost)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n, self.paused, self.probes = 0, False, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)
            if not (view or self.paused):
                self.n += 1
            return func(*args, **(kwargs or {}))

    mode = Count()
    real_scan, real_probe = ops.tap_scan, ops.tap_probe

    def unseen(*a):
        mode.paused = True
        try:
            real_scan(*a)
        finally:
            mode.paused = False

    def one_op(*a):
        mode.paused = True
        try:
            real_probe(*a)
        finally:
            mode.paused = False
        mode.n += 1
        mode.probes += 1

    monkeypatch.setattr(ops, "tap_scan", unseen)
    monkeypatch.setattr(ops, "tap_probe", one_op)

    def count(Tn, telemetry):
        mode.n = mode.probes = 0
        with mode:
            P.simulate(P.CarbonIntensityPolicy(V=0.05), tfs._base(M, N),
                       P.RandomCarbonSource(N=N), P.UniformArrivals(M=M), Tn, 42, device="cpu",
                       record="summary", telemetry=telemetry)
        assert mode.probes == (Tn if telemetry is not None else 0)
        return mode.n

    added = [count(Tn, CFG) - count(Tn, None) for Tn in (16, 32)]
    per_slot = (added[1] - added[0]) / 16
    assert 0 < per_slot <= 10, (added, per_slot)
