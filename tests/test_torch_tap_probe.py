"""The probe's per-slot sums (`kernels.taps.tap_probe_plain`, the CPU path
of `ops.tap_probe`) against the JAX package.

XLA:CPU does not add a `jnp.sum` in one order: it rewrites it into
reduce-windows of 32 with split zero pads, and its LLVM backend, which
marks a reduction's adds `reassoc`, splits some of the loops into vector
lanes. `numerics.sum_plan` writes that order down (ROADMAP hazard 34):

* `plan_sum` is bitwise `jit(jnp.sum)` over one or two trailing axes, and
  per column, on data whose sums depend on their order (non-integral,
  mixed signs, magnitudes 1e-3..1e9), at the port's widths (M4096 x N256,
  M2048 x N64, M4096 x L512), off the 32-grid (M33, M5 x N5, L10, one
  padded row or column), at every slab the vectorizer splits, and with
  one and two lane axes;
* inside the simulators' scans: from queues crafted past 2**24 (state0
  of non-integral values), the port's frames are bitwise JAX's (backlog,
  dispatched, arrived, retry_depth, transfer_occupancy, the residual and
  the peak) on `simulate`, the WAN loop and both faulted loops, and the
  faulted loops' backlog series with taps off too; under `vmap` (the
  fleet's context) the plain probe on JAX's recorded queues gives JAX's
  backlog;
* at bench_stream_overhead's instance (M2048 x N64, UK source, T=192,
  where the backlog passes 2**24 near slot 56) the port's frame is JAX's
  bitwise, the emission fields within the emissions' rtol 1e-6.

chip_smoke.py holds the CUDA kernel bitwise to this plain version on the
card.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.faults as JF  # noqa: E402
import repro.network as JN  # noqa: E402
import repro.telemetry as JT  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
import repro_torch.network as PN  # noqa: E402
import repro_torch.telemetry as PT  # noqa: E402
from repro.configs import fleet_scenarios as jfs  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.numerics import plan_sum, sum_plan  # noqa: E402
from repro_torch.kernels.taps import ProbePlan  # noqa: E402

f32 = np.float32


def _data(rng, shape):
    """Values whose float32 sums depend on the order they are added in."""
    x = (rng.uniform(0, 1, shape) * 10.0 ** rng.integers(-3, 9, shape)).astype(f32)
    x[rng.uniform(size=shape) < 0.3] *= -1
    return x


def _bits(x):
    return np.asarray(x, f32).view(np.int32)


# (lanes, rows, cols or None for 1-D, by column)
_SHAPES = [
    ((), 4096, 256, False), ((), 4096, 256, True), ((), 2048, 64, False), ((), 2048, 64, True),
    ((), 4096, 512, False), ((), 4096, None, False), ((), 2048, None, False),
    ((), 5, 5, False), ((), 5, 10, False), ((), 5, 5, True), ((), 33, 5, False),
    ((), 33, 5, True), ((), 33, 33, False), ((), 63, 63, False), ((), 127, 63, False),
    ((), 63, 2, False), ((), 95, 8, False), ((), 64, 5, False), ((), 64, 7, False),
    ((), 4, 3, False), ((), 16, 7, False), ((), 28, 2, False), ((), 20, 6, False),
    ((), 8, 100, False), ((), 1000, 40, False), ((), 33, None, False), ((), 63, None, False),
    ((3,), 5, 5, False), ((3,), 2048, 64, False), ((3,), 64, 6, False), ((2, 3), 33, 10, False),
    ((2, 3), 4, 3, False), ((2, 3), 40, 5, True), ((16,), 128, 8, False),
]


@pytest.mark.parametrize("lanes,rows,cols,by_column", _SHAPES,
                         ids=[f"{ln}x{r}x{c}{'-col' if b else ''}" for ln, r, c, b in _SHAPES])
def test_plan_sum_is_xla_order(lanes, rows, cols, by_column):
    rng = np.random.default_rng(rows * 131 + (cols or 0))
    shape = lanes + ((rows,) if cols is None else (rows, cols))
    x = _data(rng, shape)
    fn = (lambda a: jnp.sum(a, axis=0)) if by_column else jnp.sum
    for _ in lanes:
        fn = jax.vmap(fn)
    want = np.asarray(jax.jit(fn)(x))
    tx = torch.from_numpy(x)
    got = plan_sum(tx if cols is not None else tx[..., None],
                   sum_plan(rows, cols or 1, by_column)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_sum_plan_splits_where_the_vectorizer_does():
    """The plan of the port's widths: main's Qc (32x32 windows, then a
    32x8 window in 4 lanes), the stream instance's (32x2 in 8 lanes),
    W2's Qt (32x16 in order), and one padded row (lo 0, hi 1)."""
    assert [(v.w0, v.w1, v.lanes) for v in sum_plan(4096, 256).levels] == \
        [(32, 32, 1), (32, 8, 4), (4, 1, 1)]
    assert [(v.w0, v.w1, v.lanes) for v in sum_plan(2048, 64).levels] == \
        [(32, 32, 1), (32, 2, 8), (2, 1, 1)]
    assert [(v.w0, v.w1, v.lanes) for v in sum_plan(4096, 512).levels] == \
        [(32, 32, 1), (32, 16, 1), (4, 1, 1)]
    v = sum_plan(63, 5).levels[0]
    assert (v.lo0, v.lanes, v.nvec) == (0, 4, 31)
    assert sum_plan(127, 63).levels[0].last_col and not sum_plan(33, 40).levels[0].last_col
    assert [v.o1 for v in sum_plan(4096, 256, by_column=True).levels] == [256, 256, 256]


def test_probe_plan_refuses_what_the_kernel_does_not_take():
    z = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="rows"):
        ProbePlan((2,), 8, {"arrived": torch.zeros((3, 4))}, {"arrived": z})
    with pytest.raises(ValueError, match="backlog"):
        ProbePlan((2,), 8, {"part0": torch.zeros((2, 4))}, {}, ("part0",))
    with pytest.raises(ValueError, match="at most"):
        ProbePlan((2,), 8, {f"part{i}": torch.zeros((2, 4)) for i in range(7)}, {})


def test_tap_probe_plain_writes_every_series():
    """One slot through the plain probe: each series its input's sum in
    the plan's order (the landings by cloud), the backlog its parts left
    to right with a named sum reused, other slots untouched."""
    rng = np.random.default_rng(3)
    lanes, T, M, N = (2,), 6, 70, 9
    land, a, Qe, Qc, retry = (torch.from_numpy(_data(rng, s)) for s in
                              ((2, M, N), (2, M), (2, M), (2, M, N), (2, M, N)))
    series = {n: torch.zeros((2, T)) for n in ("arrived", "retry_depth", "backlog")}
    series["dispatched"] = torch.zeros((2, T, N))
    inputs = {"dispatched": land, "arrived": a, "retry_depth": retry, "part0": Qe, "part1": Qc}
    plan = ProbePlan(lanes, T, inputs, {n: series[n] for n in inputs if n in series},
                     ("part0", "part1", "retry_depth"), series["backlog"],
                     by_column=("dispatched",))
    ops.tap_probe(plan, 4, inputs)
    j = {"dispatched": jax.vmap(lambda x: jnp.sum(x, axis=0)), "sum": jax.vmap(jnp.sum)}
    np.testing.assert_array_equal(series["dispatched"][:, 4].numpy(),
                                  np.asarray(jax.jit(j["dispatched"])(land.numpy())))
    sums = {n: np.asarray(jax.jit(j["sum"])(x.numpy())) for n, x in
            (("a", a), ("Qe", Qe), ("Qc", Qc), ("retry", retry))}
    np.testing.assert_array_equal(series["arrived"][:, 4].numpy(), sums["a"])
    np.testing.assert_array_equal(series["retry_depth"][:, 4].numpy(), sums["retry"])
    np.testing.assert_array_equal(series["backlog"][:, 4].numpy(),
                                  (sums["Qe"] + sums["Qc"]) + sums["retry"])
    for x in series.values():
        assert not x[:, :4].any() and not x[:, 5:].any()


# ------------------------------------------------------- inside the scans

KINDS = ["plain", "wan", "faulted", "wan-faulted"]
T_RUN = 4


def _crafted(M, N):
    """Queues past 2**24 whose sums depend on their order."""
    rng = np.random.default_rng(M * 7 + N)
    Qe0 = (rng.uniform(0, 1, M) * 10.0 ** rng.integers(0, 7, M)).astype(f32)
    Qc0 = (rng.uniform(0, 1, (M, N)) * 10.0 ** rng.integers(0, 7, (M, N))).astype(f32)
    Qc0[0, 0] = 2 ** 25 + 0.5
    return Qe0, Qc0


def _run(kind, M, N, jax_side, telemetry=True):
    Qe0, Qc0 = _crafted(M, N)
    core, net, flt = (J, JN, JF) if jax_side else (P, PN, PF)
    dev = {} if jax_side else {"device": "cpu"}
    kw = {}
    if kind.startswith("wan"):
        pol = net.NetworkAwareDPPPolicy(V=0.05)
        kw["graph"] = net.star_graph(M, N, np.random.default_rng(7))
        if kind == "wan-faulted":
            kw["faults"] = flt.make_faults(N, kw["graph"].L, task_p_fail=0.1, link_p_down=0.2,
                                           link_p_up=0.5, link_floor=0.0, **dev)
    else:
        pol = core.CarbonIntensityPolicy(V=0.05)
        if kind == "faulted":
            kw["faults"] = flt.make_faults(N, task_p_fail=0.1, cloud_p_down=0.1, cloud_p_up=0.5,
                                           telem_p_down=0.1, telem_p_up=0.5, **dev)
    if jax_side:
        state0, key = J.NetworkState(Qe=jnp.asarray(Qe0), Qc=jnp.asarray(Qc0)), \
            jax.random.PRNGKey(1)
        tel, spec = JT.TelemetryConfig(), jfs._base(M, N)
    else:
        state0, key = P.NetworkState(Qe=torch.from_numpy(Qe0), Qc=torch.from_numpy(Qc0)), 1
        tel, spec = PT.TelemetryConfig(), tfs._base(M, N)
    return core.simulate(pol, spec, core.RandomCarbonSource(N=N), core.UniformArrivals(M=M),
                         T_RUN, key, state0=state0, telemetry=tel if telemetry else None,
                         record="full", **kw, **dev)


PROBED = ("backlog", "dispatched_cloud", "arrived", "retry_depth", "transfer_occupancy",
          "conservation_residual", "peak_backlog", "alert_count")
_SIZES = [(kind, M, N) for kind in KINDS for M, N in ((5, 5), (33, 5))] + \
    [("plain", 2048, 64), ("plain", 100, 40), ("faulted", 100, 40)]


@pytest.mark.parametrize("kind,M,N", _SIZES, ids=[f"{k}-M{m}xN{n}" for k, m, n in _SIZES])
def test_probe_in_the_scan_is_jax_past_two_to_the_24(kind, M, N):
    """From crafted non-integral queues past 2**24 the port's queues are
    JAX's, and so is every probed field of the frame; the backlog's sums
    in torch's own order would differ."""
    ref, got = _run(kind, M, N, True), _run(kind, M, N, False)
    for name in ("Qe", "Qc"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    for name in PROBED:
        np.testing.assert_array_equal(getattr(got.telemetry, name).numpy(),
                                      np.asarray(getattr(ref.telemetry, name)), err_msg=name)
    assert float(got.telemetry.backlog.min()) > 2 ** 24
    naive = torch.sum(got.Qe, dim=-1) + torch.sum(got.Qc, dim=(-2, -1))
    if kind == "plain":
        assert not torch.equal(naive, got.telemetry.backlog)


@pytest.mark.parametrize("kind", ["faulted", "wan-faulted"])
def test_faulted_backlog_series_is_jax_with_taps_off(kind):
    """The faulted loops' backlog series comes from the probe with taps
    off too: JAX's bits, and bitwise the taps-on run's."""
    ref = _run(kind, 33, 5, True, telemetry=False)
    off, on = _run(kind, 33, 5, False, telemetry=False), _run(kind, 33, 5, False)
    np.testing.assert_array_equal(off.backlog.numpy(), np.asarray(ref.backlog))
    assert torch.equal(off.backlog, on.backlog)


def test_probe_under_vmap_is_jax():
    """The fleet's context: JAX's simulate vmapped over lanes (each its
    own crafted state0), its backlog against the plain probe on the
    recorded queues with a lane axis."""
    F, M, N = 3, 64, 6
    rng = np.random.default_rng(11)
    Qe0 = (rng.uniform(0, 1, (F, M)) * 10.0 ** rng.integers(0, 7, (F, M))).astype(f32)
    Qc0 = (rng.uniform(0, 1, (F, M, N)) * 10.0 ** rng.integers(0, 7, (F, M, N))).astype(f32)
    keys = jax.random.split(jax.random.PRNGKey(2), F)

    def one(qe, qc, k):
        return J.simulate(J.CarbonIntensityPolicy(V=0.05), jfs._base(M, N),
                          J.RandomCarbonSource(N=N), J.UniformArrivals(M=M), T_RUN, k,
                          state0=J.NetworkState(Qe=qe, Qc=qc), telemetry=JT.TelemetryConfig(),
                          record="full")

    ref = jax.jit(jax.vmap(one))(Qe0, Qc0, keys)
    backlog = torch.zeros((F, T_RUN))
    for t in range(T_RUN):
        inputs = {"part0": torch.from_numpy(np.array(ref.Qe[:, t])),
                  "part1": torch.from_numpy(np.array(ref.Qc[:, t]))}
        plan = ProbePlan((F,), T_RUN, inputs, {}, ("part0", "part1"), backlog)
        ops.tap_probe(plan, t, inputs)
    np.testing.assert_array_equal(backlog.numpy(), np.asarray(ref.telemetry.backlog))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stream_instance_frame_is_jax():
    """bench_stream_overhead's instance (M2048 x N64, UK source, T=192):
    the port's frame bitwise JAX's, its backlog past 2**24 from slot 56
    on; the emission fields within rtol 1e-6."""
    cs = _chip_smoke()
    pe, pc, Pe, Pc = cs.stream_instance_arrays()
    spec_j = J.NetworkSpec(pe, pc, Pe, Pc)
    ref = jax.jit(lambda k: J.simulate(  # as STREAM_JAX was taken
        J.CarbonIntensityPolicy(V=cs.V_FAULT), spec_j, J.UKRegionalTraceSource(N=cs.N_STREAM),
        J.UniformArrivals(M=cs.M_STREAM, amax=cs.A_STREAM), cs.T_STREAM, k, record="summary",
        telemetry=JT.TelemetryConfig()))(jax.random.PRNGKey(cs.SEED)).telemetry
    from repro_torch import convert

    got = P.simulate(P.CarbonIntensityPolicy(V=cs.V_FAULT),
                     convert.spec_from_numpy(pe, pc, Pe, Pc, "cpu"),
                     P.UKRegionalTraceSource(N=cs.N_STREAM),
                     P.UniformArrivals(M=cs.M_STREAM, amax=cs.A_STREAM), cs.T_STREAM, cs.SEED,
                     record="summary", device="cpu", telemetry=PT.TelemetryConfig()).telemetry
    for name in PT.Telemetry._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in ("emission_rate", "total_emissions"):
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert float(got.backlog.max()) > 2 ** 24
    row = cs.manifest_row(PT.manifest(got))
    assert row[0] == cs.STREAM_JAX[0] and row[4] == cs.STREAM_JAX[4]
    np.testing.assert_allclose(row[1:4], cs.STREAM_JAX[1:4], rtol=cs.TEL_RTOL)
