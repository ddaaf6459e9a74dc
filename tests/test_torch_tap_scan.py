"""The tap kernel's plain version (`kernels.taps.tap_scan_plain`, the CPU
path of `ops.tap_scan`) against the JAX package's taps: `step_taps` run
in a `lax.scan` and `finalize_taps` after it, under `jit` (with `vmap`
for lanes), as the JAX simulators run them.

Hypothesis draws probe series whose backlogs and counts pass 2**24
(where float32 sums depend on their order: the running sums must be
sequential, as the scan's carry is) with non-integer emissions and
waste (whose totals must follow XLA:CPU's reduce order), random monitor
thresholds, lengths on both sides of the 32-slot reduce window, and
lanes; every field of the frame, and the end state, must be bitwise
JAX's. chip_smoke.py holds the CUDA kernel bitwise to this plain
version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.telemetry as JT  # noqa: E402
import repro_torch.telemetry as PT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.taps import TapOut, unpack_state  # noqa: E402

N = 3


def _series(rng, lanes, T, big):
    """A probe series [*lanes, T] of the loops' kinds of values: integral
    counts (past 2**24 when `big`), non-integral emissions and waste."""
    hi = 2 ** 26 if big else 400
    shape = lanes + (T,)
    ints = lambda h: rng.integers(0, h, shape).astype(np.float32)  # noqa: E731
    arrived = ints(hi)
    processed = np.minimum(ints(hi), arrived)
    backlog = np.cumsum(arrived - processed, axis=-1, dtype=np.float64).astype(np.float32)
    backlog += ints(3)  # a leak now and then: the drift monitor fires
    return dict(
        emissions=(rng.uniform(0, 1, shape) * 10.0 ** rng.integers(-3, 9, shape)).astype(
            np.float32),
        arrived=arrived, processed=processed,
        failed=np.minimum(ints(hi // 8 + 1), processed), wasted=rng.uniform(0, 3e4, shape).astype(
            np.float32) * (rng.uniform(size=shape) < 0.5),
        backlog=backlog, stale=rng.integers(0, 9, shape).astype(np.int32),
        clouds_down=rng.integers(0, N + 1, shape).astype(np.float32),
        retry_depth=ints(hi), transfer_occupancy=ints(hi),
        missed=ints(5) * (rng.uniform(size=shape) < 0.3),
        shed=ints(hi // 4 + 1) * (rng.uniform(size=shape) < 0.3),
        dispatched=rng.integers(0, 50, shape + (N,)).astype(np.float32))


_JITTED = {}


def _jax_frame(cfg, s):
    """JAX's taps over the series: the scan of step_taps, then
    finalize_taps, under jit (vmapped over one lane axis; one jitted
    program a config and lane count, compiled once a length)."""
    lanes = s["backlog"].ndim - 1
    fn = _JITTED.get((cfg, lanes))
    if fn is None:
        def run(probe):
            tap, series = jax.lax.scan(lambda tp, p: JT.step_taps(cfg, tp, p), JT.init_taps(),
                                       probe)
            return tap, JT.finalize_taps(cfg, series)

        fn = _JITTED[(cfg, lanes)] = jax.jit(jax.vmap(run, in_axes=1) if lanes else run)
    probe = JT.TelemetryProbe(**{k: jnp.asarray(v) for k, v in s.items()})
    return fn(jax.tree.map(lambda x: jnp.moveaxis(x, lanes, 0), probe))


def _port_frame(cfg, s, chunks=None):
    probe = PT.TelemetryProbe(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in s.items()})
    lanes, T = tuple(s["backlog"].shape[:-1]), s["backlog"].shape[-1]
    out, state = TapOut.empty(lanes, T, "cpu"), torch.zeros(lanes + (7,))
    bounds = [0] + list(chunks or []) + [T]
    for t0, t1 in zip(bounds, bounds[1:]):
        ops.tap_scan(cfg, probe, out, state, t0, t1)
    return unpack_state(state), out.frame(probe)


def _assert_same(cfg_kw, s, chunks=None):
    jtap, jtel = _jax_frame(JT.TelemetryConfig(**cfg_kw), s)
    ptap, ptel = _port_frame(PT.TelemetryConfig(**cfg_kw), s, chunks)
    for name in PT.Telemetry._fields:
        a, b = getattr(ptel, name).numpy(), np.asarray(getattr(jtel, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in PT.TapState._fields:
        np.testing.assert_array_equal(getattr(ptap, name).numpy(), np.asarray(getattr(jtap, name)),
                                      err_msg=name)
    return ptel


# the defaults, and thresholds float32 does not hold exactly
_CONFIGS = [
    {},
    dict(growth_thresh=0.1, growth_sustain=3, stale_budget=2, drift_tol=0.3, miss_tol=0.7,
         shed_frac=0.1),
    dict(growth_thresh=-1.0, growth_sustain=1, stale_budget=0, drift_tol=2.0, miss_tol=2.0,
         shed_frac=0.3),
]
_THRESH = st.sampled_from(_CONFIGS)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), T=st.sampled_from([1, 7, 32, 33, 100]),
       lanes=st.sampled_from([(), (3,)]), big=st.booleans(), cfg=_THRESH)
def test_tap_scan_plain_matches_jax(seed, T, lanes, big, cfg):
    _assert_same(cfg, _series(np.random.default_rng(seed), lanes, T, big))


@pytest.mark.parametrize("T", [192, 1025])
def test_long_runs_past_two_to_the_24(T):
    """Running sums and totals far past 2**24 (two and three levels of
    the 32-slot reduce window), in chunks from the carried state."""
    s = _series(np.random.default_rng(T), (2,), T, big=True)
    tel = _assert_same({}, s, chunks=[16, 17, 100])
    assert float(tel.total_arrived.max()) > 2 ** 30
    assert int(tel.alert_count[:, PT.MONITORS.index("conservation_drift")].min()) > 0


def test_the_totals_follow_xla_order():
    """A total that a sequential float32 sum (the scan's order) gets
    wrong: only XLA:CPU's window order gives JAX's bits."""
    s = _series(np.random.default_rng(5), (), 200, big=True)
    tel = _assert_same({}, s)
    seq = np.float32(0.0)
    for x in s["emissions"]:
        seq = np.float32(seq + x)
    assert float(tel.total_emissions) != float(seq)


def _nan(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


# backlogs whose peak is decided by jnp.max's rule: -0 below +0, a NaN wins
_PEAKS = {
    "-0 then +0": [-0.0, 0.0, -1.0], "+0 then -0": [0.0, -0.0, -3.0], "only -0": [-0.0, -0.0],
    "NaN inside": [1.0, _nan(0x7FC00000), 5.0], "NaN first": [_nan(0x7FC00000), 1.0],
    "-NaN": [1.0, _nan(0xFFC00000), 2.0], "a NaN with a payload": [2.0, _nan(0x7FC00005)],
    "all below 0": [-5.0, -2.0, -7.0],
}


@pytest.mark.parametrize("T", [3, 40, 300])
@pytest.mark.parametrize("case", list(_PEAKS))
def test_peak_ties_and_nans_follow_finalize_taps(case, T):
    """The peak against JAX's finalize_taps where a max's tie and NaN
    rule decide it: the bits of +0 and -0 (a +0 anywhere wins), NaN
    wherever a NaN is; placed at the start, and mid-run past a window."""
    s = _series(np.random.default_rng(T), (2,), T, big=False)
    s["backlog"] = np.full((2, T), -9.0, np.float32)
    vals = np.array(_PEAKS[case], np.float32)
    s["backlog"][0, :len(vals)] = vals
    s["backlog"][1, T - len(vals):] = vals
    tel = _assert_same({}, s, chunks=[1] if T > 3 else None)
    _, jtel = _jax_frame(JT.TelemetryConfig(), s)
    got, want = tel.peak_backlog.numpy(), np.asarray(jtel.peak_backlog)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32), want[ok].view(np.int32))


@pytest.mark.parametrize("T,chunks", [(600, [1, 255, 256, 257, 300, 511]), (1100, [700, 1023]),
                                      (257, [256])])
def test_runs_longer_than_a_kernel_tile_in_chunks(T, chunks):
    """Runs past the CUDA kernel's 256-slot tile, in chunks that end mid
    tile and on its edges (the kernel's staging; the plain version has
    no tiles): every field and the end state JAX's, past 2**24."""
    s = _series(np.random.default_rng(T + 1), (3,), T, big=True)
    tel = _assert_same(dict(_CONFIGS[1]), s, chunks=chunks)
    assert float(tel.total_arrived.max()) > 2 ** 30
