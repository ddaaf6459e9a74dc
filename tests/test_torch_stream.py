"""The port's streaming taps (`repro_torch.telemetry.stream`).

The anchors of `tests/test_stream.py`, in the port (no JAX needed but for
the frames it is held to):

* a StreamConfig run gives the same values as the TelemetryConfig run,
  every result field and every Telemetry field bitwise, the gauges
  included (both paths run the same tap kernel over the same series; the
  last chunk's launch computes the run's reductions), on every kind of
  run, in every record mode and at any flush cadence;
* a streamed run launches the tap kernel once a chunk, a batch run once;
* the host channel's reassembled series equal the batch frame bitwise;
  a fleet's flushes are tagged with their lane;
* the channel's ring buffer drops the oldest slices past its capacity,
  while subscribers still see every flush;
* `follow_run` round-trips the flushed slices and its outputs validate;
  against JAX, its live files are the same events as JAX's on the same
  slices;
* JAX's refusals: flush_every must divide T, and record must be full,
  summary or the stride flush_every.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers

import repro_torch.core as P  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
import repro_torch.network as PN  # noqa: E402
import repro_torch.telemetry as PT  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import taps as ktaps  # noqa: E402
from repro_torch.telemetry.taps import TapSeries  # noqa: E402

T = 48
M, N = 4, 3
K_FLUSH = 16
KINDS = ["plain", "wan", "faulted", "wan-faulted"]


def _run(kind, telemetry, record="full"):
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


def _assert_result_equal(a, b):
    for field in type(a)._fields:
        x, y = getattr(a, field), getattr(b, field)
        if field in ("telemetry", "deadlines") and x is not None:
            for name, u, v in zip(type(x)._fields, x, y):
                assert u.dtype == v.dtype and torch.equal(u, v), name
        elif x is not None:
            assert torch.equal(x, y), field


def _assert_channel_matches(frame, series):
    for field in TapSeries._fields:
        want = getattr(frame, field).numpy()
        got = np.asarray(getattr(series, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


def _counting(monkeypatch):
    """Counts the tap scans (the kernel's launches, on the card)."""
    calls = []
    real = ktaps.tap_scan_plain

    def counted(cfg, probe, out, state, t0, t1):
        calls.append((t0, t1))
        real(cfg, probe, out, state, t0, t1)

    monkeypatch.setattr(ktaps, "tap_scan_plain", counted)
    return calls


def test_split():
    assert PT.split_telemetry(None) == (None, None)
    tcfg = PT.TelemetryConfig()
    assert PT.split_telemetry(tcfg) == (tcfg, None)
    scfg = PT.StreamConfig(flush_every=8, channel="t")
    assert PT.split_telemetry(scfg) == (scfg.taps, scfg)
    assert hash(scfg) == hash(PT.StreamConfig(flush_every=8, channel="t"))
    with pytest.raises(ValueError):
        PT.StreamConfig(flush_every=0)


def test_refusals():
    with pytest.raises(ValueError, match="divide T"):
        _run("plain", PT.StreamConfig(flush_every=7, channel="t-div"))
    with pytest.raises(ValueError, match="record must be"):
        _run("plain", PT.StreamConfig(flush_every=8, channel="t-str"), record=16)
    _run("plain", PT.StreamConfig(flush_every=8, channel="t-str"), record=8)


@pytest.mark.parametrize("kind", KINDS)
def test_stream_equals_taps(kind, monkeypatch):
    name = f"t-par-{kind}"
    PT.reset_channel(name)
    calls = _counting(monkeypatch)
    r_taps = _run(kind, PT.TelemetryConfig())
    assert calls == [(0, T)]
    calls.clear()
    r_stream = _run(kind, PT.StreamConfig(flush_every=K_FLUSH, channel=name))
    assert calls == [(t, t + K_FLUSH) for t in range(0, T, K_FLUSH)]
    _assert_result_equal(r_taps, r_stream)
    ch = PT.channel(name)
    assert ch.flushes == T // K_FLUSH and ch.lanes() == [0]
    _assert_channel_matches(r_taps.telemetry, ch.series(0))


@pytest.mark.parametrize("record", ["full", "summary", K_FLUSH])
def test_record_modes(record):
    name = f"t-rec-{record}"
    PT.reset_channel(name)
    r_taps = _run("faulted", PT.TelemetryConfig(), record=record)
    r_stream = _run("faulted", PT.StreamConfig(flush_every=K_FLUSH, channel=name), record=record)
    _assert_result_equal(r_taps, r_stream)
    _assert_channel_matches(r_taps.telemetry, PT.channel(name).series(0))


@pytest.mark.parametrize("k", [1, 8, 24, 48])
def test_flush_cadence_is_value_neutral(k):
    base = _run("wan", PT.TelemetryConfig())
    name = f"t-k{k}"
    PT.reset_channel(name)
    _assert_result_equal(base, _run("wan", PT.StreamConfig(flush_every=k, channel=name)))
    _assert_channel_matches(base.telemetry, PT.channel(name).series(0))
    assert PT.channel(name).flushes == T // k


def test_fleet_flushes_are_lane_tagged(monkeypatch):
    name = "t-fleet"
    PT.reset_channel(name)
    fleet = tfs.with_deadlines(tfs.build_fleet(["diurnal-slack", "overload"], per_kind=2, M=M, N=N,
                                               Tc=24, seed=0, device="cpu"), "shed-overload")
    pol = P.CarbonIntensityPolicy(V=0.05)
    batch = P.simulate_fleet(pol, fleet, T, 1, record="summary", device="cpu",
                             telemetry=PT.TelemetryConfig())
    calls = _counting(monkeypatch)
    res = P.simulate_fleet(pol, fleet, T, 1, record="summary", device="cpu",
                           telemetry=PT.StreamConfig(flush_every=K_FLUSH, channel=name))
    assert len(calls) == T // K_FLUSH  # one scan a chunk covers every lane
    _assert_result_equal(batch, res)
    ch = PT.channel(name)
    assert ch.lanes() == list(range(fleet.F)) and ch.flushes == fleet.F * T // K_FLUSH
    for i in range(fleet.F):
        _assert_channel_matches(PT.lane(res.telemetry, i), ch.series(i))


def test_channel_ring_buffer():
    ch = PT.StreamChannel("ring", capacity=3)
    seen = []
    fn = ch.subscribe(lambda lane, t0, s: seen.append((lane, t0)))
    row = TapSeries(*(np.full((2,), i, np.float32) for i in range(len(TapSeries._fields))))
    for t0 in range(0, 10, 2):
        ch.push(0, t0, row)
    assert ch.flushes == 5 and ch.dropped == 2 and len(seen) == 5
    assert ch.series(0).backlog.shape == (6,)  # the three newest slices
    ch.unsubscribe(fn)
    ch.push(1, 0, row)
    assert len(seen) == 5 and ch.lanes() == [0, 1]
    with pytest.raises(ValueError, match="no slices for lane 7"):
        ch.series(7)
    ch.clear()
    assert ch.flushes == 0 and ch.lanes() == []
    assert PT.channel("ring-named", capacity=2) is PT.channel("ring-named")


def test_follow_run_live_export(tmp_path):
    name = "t-follow"
    PT.reset_channel(name)
    with PT.follow_run(channel=name, outdir=tmp_path) as run:
        r = _run("faulted", PT.StreamConfig(flush_every=K_FLUSH, channel=name))
        paths = run.paths
    assert run.slots == T and run.lanes() == [0]
    _assert_channel_matches(r.telemetry, run.series(0))
    events = paths["jsonl"].read_text()
    assert PT.validate_jsonl(events) == T + 1
    assert PT.validate_prometheus(paths["prometheus"].read_text()) > 0
    slots = [json.loads(x) for x in events.splitlines()][:-1]
    assert [ev["t"] for ev in slots] == list(range(T))
    np.testing.assert_allclose(run.totals()["total_emissions"],
                               float(r.telemetry.total_emissions), rtol=1e-6)
    run.close()  # closing twice is a no-op
    assert PT.validate_dir(tmp_path, formats=("prom", "jsonl"))


def test_follow_run_without_outdir():
    name = "t-mem"
    PT.reset_channel(name)
    run = PT.follow_run(channel=name)
    r = _run("plain", PT.StreamConfig(flush_every=K_FLUSH, channel=name))
    run.close()
    assert run.slots == T and run.paths == {}
    _assert_channel_matches(r.telemetry, run.series(0))
    assert PT.validate_prometheus(run.to_prometheus()) > 0


def test_follow_run_events_equal_jax(tmp_path):
    """The live consumer writes JAX's bytes for the same slices: JAX's
    FollowedRun and the port's fed the same pushes."""
    JT = pytest.importorskip("repro.telemetry")
    r = _run("wan-faulted", PT.TelemetryConfig())
    slices = PT.stream.host_slices(TapSeries(*r.telemetry[:len(TapSeries._fields)]), 0, T)
    outs = []
    for pkg, d in ((PT, tmp_path / "port"), (JT, tmp_path / "jax")):
        ch = pkg.reset_channel("t-bytes")
        run = pkg.follow_run(channel="t-bytes", outdir=d)
        for t0 in range(0, T, K_FLUSH):
            sl = type(slices[0])(*(x[t0:t0 + K_FLUSH] for x in slices[0]))
            ch.push(0, t0, sl if pkg is PT else JT.stream.TapSeries(*sl))
        run.close()
        outs.append((run.paths["jsonl"].read_text(), run.paths["prometheus"].read_text()))
    assert outs[0] == outs[1]


def test_kernel_state_carries_across_chunks():
    """tap_scan over [0, T) at once equals the same scan in chunks from the
    carried packed state, state included (the plain version here; the
    kernel is held to it on the card)."""
    r = _run("faulted", PT.TelemetryConfig())
    probe = PT.TelemetryProbe(
        emissions=r.telemetry.emission_rate, arrived=r.telemetry.arrived,
        dispatched=r.telemetry.dispatched_cloud, processed=r.telemetry.processed,
        failed=r.telemetry.failed, wasted=r.telemetry.wasted, backlog=r.telemetry.backlog,
        stale=r.telemetry.staleness, clouds_down=r.telemetry.clouds_down,
        retry_depth=r.telemetry.retry_depth, transfer_occupancy=r.telemetry.transfer_occupancy,
        missed=r.telemetry.missed, shed=r.telemetry.shed)
    cfg = PT.TelemetryConfig()
    whole, s1 = ktaps.TapOut.empty((), T, "cpu"), torch.zeros(7)
    ops.tap_scan(cfg, probe, whole, s1, 0, T)
    parts, s2 = ktaps.TapOut.empty((), T, "cpu"), torch.zeros(7)
    for t0, t1 in ((0, 5), (5, 6), (6, 40), (40, T)):
        ops.tap_scan(cfg, probe, parts, s2, t0, t1)
    for name, a, b in zip(ktaps.TapOut._fields, whole, parts):
        assert torch.equal(a, b), name
    assert torch.equal(s1, s2)
    st = ktaps.unpack_state(s1)
    assert st.growth_run.dtype == torch.int32
    assert float(st.cum_arrived) == float(r.telemetry.arrived.double().sum())
    assert torch.equal(ktaps.pack_state(st), s1)
