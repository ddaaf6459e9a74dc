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
import ctypes
import importlib.util
import math
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
from repro_torch.kernels import taps as tpk  # noqa: E402
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
    with pytest.raises(ValueError, match="by column"):
        ProbePlan((2,), 8, {"part0": torch.zeros((2, 4, 3))}, {}, ("part0",), z,
                  by_column=("part0",))


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


# ------------------------------------------------ the kernel's schedule
#
# csrc/tap_probe.cu cannot run here, so its work split is modelled in
# Python from the numbers the host code puts in its argument block
# (`ProbePlan.schedule`, from `taps.probe_schedule`): block b takes the
# first-pass windows [F0, F0 + n) of one sum, lane-major; then, for each
# lane those windows touch, either the lane's first pass lies in this block
# alone or the block counts it, and the block whose count completes the
# lane takes the lane's upper passes and then counts the backlog's parts.

# chip_smoke.py 4h's shapes: (lanes, M, N, L)
_PROBE_SHAPES = {
    "main": ((), 4096, 256, None), "fleet B": ((16,), 4096, 256, None),
    "W2": ((16,), 4096, 256, 512), "bench fleet": ((32,), 5, 5, None),
    "fleet A": ((512,), 5, 5, None), "W1": ((64,), 5, 5, 10), "stream": ((), 2048, 64, None),
    "F3 x M33 x N5": ((3,), 33, 5, None), "F2 x M127 x N63": ((2,), 127, 63, None),
    "M63 x N5 x L40": ((), 63, 5, 40),
}


def _probe_plan_at(lanes, M, N, L, full=True, device="meta"):
    """chip_smoke 4h's probe at a shape: with `full`, every sum the kernel
    takes at once (the landings by cloud, arrivals, Qe, Qc, Qt where L,
    the retry pool; four backlog parts), else a fault-free loop's."""
    T = 4
    shapes = {"dispatched": (M, N), "arrived": (M,), "part0": (M,), "part1": (M, N),
              **({"transfer_occupancy": (M, L)} if L else {}),
              **({"retry_depth": (M, N)} if full else {})}
    inputs = {n: torch.empty(lanes + s, device=device) for n, s in shapes.items()}
    series = {n: torch.empty(lanes + (T,), device=device)
              for n in ("arrived", "transfer_occupancy", "retry_depth", "backlog")}
    series["dispatched"] = torch.empty(lanes + (T, N), device=device)
    parts = ("part0", "part1") + (("transfer_occupancy",) if L else ()) + \
        (("retry_depth",) if full else ())
    return ProbePlan(lanes, T, inputs, {n: series[n] for n in inputs if n in series}, parts,
                     series["backlog"], by_column=("dispatched",)), inputs, series


def _model_launch(plan, order):
    """The kernel's control flow over its blocks, finishing in `order`:
    returns how often each output of each pass of each job and lane and
    each lane's backlog was written, and the counters at the end. Asserts
    that a group's upper pass runs only after every output below it is in,
    that the backlog waits for every part's total, and that no counter
    passes its target."""
    n_lanes = math.prod(plan.lanes)
    jobs = [plan.plans[n] for n in plan.names]
    written = [[np.zeros((n_lanes, v.o0 * v.o1), np.int64) for v in pl.levels] for pl in jobs]
    count = [np.zeros(n_lanes * s.groups, np.int64) for s in plan.schedule]
    bcount = np.zeros(n_lanes, np.int64)
    backlog = np.zeros(n_lanes, np.int64)
    parts = [plan.names.index(p) for p in plan.parts]
    starts = sorted((s.task0, k) for k, s in enumerate(plan.schedule))

    def columns(v, s, g):  # a group's columns of a pass
        w = s.cw or v.o1
        return np.arange((g % s.groups) * w, min((g % s.groups + 1) * w, v.o1))

    for b in order:
        k = [k for t0, k in starts if t0 <= b][-1]
        s, v0 = plan.schedule[k], jobs[k].levels[0]
        w = s.cw or v0.o1
        per = v0.o0 * w
        F0 = (b - s.task0) * s.per_task
        n = min(s.per_task, per * n_lanes * s.groups - F0)
        assert 0 <= b - s.task0 < s.ntask and n > 0
        if v0.w1 > 1:  # wide: warp w takes P windows, lane l < count adds window F0 + w P + l
            assert s.per_task == tpk.PROBE_WARPS * s.P and 32 % s.P == 0
            assert s.groups == 1 and s.cw == 0
            if tpk.streams(v0):  # rows streamed D ahead through P x D ring rows
                assert s.D in (8, 16) and s.P * s.D <= tpk.PROBE_RING_ROWS
            else:  # staged whole: P windows of up to 32 rows
                assert s.D == 0 and s.P * 32 <= tpk.PROBE_RING_ROWS
        else:
            assert s.per_task == tpk.PROBE_THREADS
        F = np.arange(F0, F0 + n)
        g, f = F // per, F % per
        i, j = f // w, (g % s.groups) * w + f % w
        real = j < v0.o1
        np.add.at(written[k][0], (g[real] // s.groups, (i * v0.o1 + j)[real]), 1)
        for grp in range(F0 // per, (F0 + n - 1) // per + 1):
            tf, tl = grp * per // s.per_task, ((grp + 1) * per - 1) // s.per_task
            if tf != tl:
                count[k][grp] += 1
                assert count[k][grp] <= tl - tf + 1
                if count[k][grp] < tl - tf + 1:
                    continue
                count[k][grp] = 0
            lane = grp // s.groups
            for lev, v in enumerate(jobs[k].levels):
                below = written[k][lev - 1][lane].reshape(-1, jobs[k].levels[lev - 1].o1) \
                    if lev else None
                cols = columns(v, s, grp)
                if lev:  # every window of the group reads only outputs already in
                    assert (below[:, cols if s.cw else slice(None)] == 1).all(), \
                        "an upper window read too early"
                    out = written[k][lev][lane].reshape(v.o0, v.o1)
                    out[:, cols] += 1
                else:
                    assert (written[k][0][lane].reshape(v.o0, v.o1)[:, cols] == 1).all(), \
                        "a group taken before its first pass is in"
            if k in parts:
                bcount[lane] += 1
                assert bcount[lane] <= len(parts)
                if bcount[lane] == len(parts):
                    bcount[lane] = 0
                    assert all((written[q][-1][lane] == 1).all() for q in parts)
                    backlog[lane] += 1
    return written, np.concatenate(count + [bcount]), backlog


def _windows_cover(v):
    """Each pass's windows (pads clipped) cover its [rows, cols] exactly
    once, and its outputs are [o0, o1]: every child read once."""
    hits = np.zeros((v.rows, v.cols), np.int64)
    for i in range(v.o0):
        for j in range(v.o1):
            r0, c0 = i * v.w0 - v.lo0, j * v.w1 - v.lo1
            hits[max(r0, 0):max(r0 + v.w0, 0), max(c0, 0):max(c0 + v.w1, 0)] += 1
    return (hits == 1).all()


@pytest.mark.parametrize("shape", list(_PROBE_SHAPES))
def test_probe_schedule_writes_every_output_once(shape):
    """Every output of every pass of every job and lane, and every
    backlog, is written exactly once, whatever order the blocks finish
    in; each counter gets exactly its target's arrivals and ends at 0;
    each upper window is read only after all its children are in."""
    plan = _probe_plan_at(*_PROBE_SHAPES[shape])[0]
    blocks = sum(s.ntask for s in plan.schedule)
    assert sorted(b for s in plan.schedule for b in range(s.task0, s.task0 + s.ntask)) == \
        list(range(blocks)), "every block one task"
    rng = np.random.default_rng(len(shape))
    for order in (range(blocks), range(blocks - 1, -1, -1), rng.permutation(blocks)):
        written, count, backlog = _model_launch(plan, [int(b) for b in order])
        for per_job in written:
            for w in per_job:
                assert (w == 1).all()
        assert not count.any() and (backlog == 1).all()
    for name in plan.names:
        assert all(_windows_cover(v) for v in plan.plans[name].levels)


@pytest.mark.parametrize("shape", list(_PROBE_SHAPES))
def test_probe_schedule_fits_the_kernel(shape):
    """The argument block fits a kernel's parameters and its room (jobs,
    passes, parts); the wide passes start first; P and D fit the ring, P
    grows with the wide windows, and a pass's windows fit 32-bit indices."""
    lanes, M, N, L = _PROBE_SHAPES[shape]
    plan = _probe_plan_at(lanes, M, N, L)[0]
    assert ctypes.sizeof(tpk._Probe) <= 4096  # a kernel's parameters: the argument block
    assert len(plan.names) <= tpk.PROBE_JOBS and len(plan.parts) <= tpk.PROBE_PARTS
    assert all(len(p.levels) <= tpk.PROBE_LEVELS for p in plan.plans.values())
    wide = [k for k, n in enumerate(plan.names) if plan.plans[n].levels[0].w1 > 1]
    col = [k for k in range(len(plan.names)) if k not in wide]
    assert max(plan.schedule[k].task0 for k in wide) < min(plan.schedule[k].task0 for k in col)
    n_lanes = math.prod(lanes)
    n_wide = sum(n_lanes * plan.plans[plan.names[k]].levels[0].o0 *
                 plan.plans[plan.names[k]].levels[0].o1 for k in wide)
    P = max(plan.schedule[k].P for k in wide)
    assert P == tpk.PROBE_MAX_P or n_wide <= P * tpk.PROBE_CHAIN_WARPS
    assert P == 1 or n_wide > P // 2 * tpk.PROBE_CHAIN_WARPS
    for k in wide:
        v, s = plan.plans[plan.names[k]].levels[0], plan.schedule[k]
        assert (s.P, s.D) == ((P, min(16, tpk.PROBE_RING_ROWS // P)) if tpk.streams(v) else
                              (min(P, 2), 0))


def test_probe_schedule_at_the_loops_widths():
    """The split the loops' own probes get (Qc's first pass): main's 1,024
    wide windows a warp each, 16 rows ahead of the adds; fleet B's 16,384
    and W2's 49,152 (with Qt's) eight a warp, 8 rows ahead."""
    got = [_probe_plan_at(*_PROBE_SHAPES[s], full=False)[0].schedule[3]
           for s in ("main", "fleet B", "W2")]
    assert [(g.P, g.D, g.ntask) for g in got] == [(1, 16, 128), (8, 8, 256), (8, 8, 256)]


def test_probe_longest_chain_is_the_serial_floor():
    """The plans' longest chains of dependent adds: main's Qc (32 x 32,
    then 32 x 8 rows in 4 lanes, 4, the backlog's add) 1,095; W2's Qt
    (32 x 32, 32 x 16 in order, 4, the add) 1,541."""
    got = [_probe_plan_at(*_PROBE_SHAPES[s], full=False)[0].longest_chain()
           for s in ("main", "W2")]
    assert got == [1095, 1541]


def _kernel_order_sum(x, plan):
    """x [rows, cols] (one lane) summed by the kernel's walk of `plan`:
    a one-column window from +0 in order; a wide window's rows before
    `first` L at a time, row r + l into lane l (lane 0 from +0, the others
    from -0), the lanes folded pairwise, then the other rows into the sum
    in order, pads added as +0 or skipped, a padded column's values after
    all rows; float32."""
    add = lambda a, b: np.float32(np.float32(a) + np.float32(b))  # noqa: E731
    for v in plan.levels:
        y = np.zeros((v.o0, v.o1), f32)
        n = v.w1 - 1 if v.last_col else v.w1
        for i in range(v.o0):
            for j in range(v.o1):
                r0, c0 = i * v.w0 - v.lo0, j * v.w1 - v.lo1

                def row(r, upto):
                    rr = r0 + r
                    return [x[rr, c0 + c] if 0 <= rr < v.rows and 0 <= c0 + c < v.cols else f32(0)
                            for c in range(upto)]

                first, acc = 0, f32(0)
                if v.lanes > 1:
                    first = v.nvec // v.lanes * v.lanes
                    a = [f32(0)] + [f32(-0.0)] * (v.lanes - 1)
                    for r in range(0, first, v.lanes):
                        for q in range(v.lanes):
                            for val in row(r + q, n):
                                a[q] = add(a[q], val)
                    h = v.lanes // 2
                    while h:
                        a[:h] = [add(a[q], a[q + h]) for q in range(h)]
                        h //= 2
                    acc = a[0]
                for r in range(first, v.w0):
                    for val in row(r, n):
                        acc = add(acc, val)
                if v.last_col:
                    for r in range(v.w0):
                        acc = add(acc, row(r, v.w1)[-1])
                y[i, j] = acc
        x = y
    return x[0, :] if plan.by_column else x[0, 0]


@pytest.mark.parametrize("rows,cols,by_column", [
    (33, 5, False), (127, 63, False), (63, 5, False), (63, 40, False), (5, 5, False),
    (64, 7, False), (16, 7, False), (20, 6, False), (28, 2, False), (95, 8, False),
    (1000, 40, False), (2048, 64, False), (4096, 8, False), (127, 63, True), (33, 5, True)])
def test_kernel_walk_is_the_plan(rows, cols, by_column):
    """The kernel's walk of a window (rows into L lane sums a group of L at
    a time, padded values skipped or added as +0, a padded column's values
    read again at the end), emulated in float32, is bitwise plan_sum
    on data whose sums depend on their order, wherever the vectorizer
    splits a window into lanes or a column is padded."""
    rng = np.random.default_rng(rows * 17 + cols)
    x = _data(rng, (rows, cols))
    plan = sum_plan(rows, cols, by_column)
    want = plan_sum(torch.from_numpy(x), plan).numpy()
    np.testing.assert_array_equal(_bits(_kernel_order_sum(x, plan)), _bits(want))


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
