"""The telemetry tap recurrence over a run: plain PyTorch version and
CUDA wrapper.

Counterpart of `repro.telemetry.taps.step_taps` run inside the JAX
simulators' scan, slot after slot, and of `finalize_taps` after it. The
port's loops record the probe's raw fields over the run (a
`TelemetryProbe` whose fields are [*lanes, T], `dispatched` [*lanes, T,
N]); one `tap_scan` over slots t0..t1-1 then walks, for every lane,

  growth     = backlog - prev_backlog
  growth_run = growth > growth_thresh ? growth_run + 1 : 0
  cum_x     += x            (arrived, processed, failed, missed, shed)
  residual   = cum_arrived - (backlog + cum_processed - cum_failed)
               - cum_missed - cum_shed
  alerts     = the six `monitors.MONITORS` conditions

from the carried state, and when the slots reach the run's end (t1 = T)
also the reductions over [0, T): the peak backlog, the seven totals in
XLA:CPU's order (`numerics.xla_sum`) and the alert records. A batch run
is one call over [0, T); a streamed run one call a flush chunk, so its
frame is bitwise the batch frame.

The state is packed in one float32 [*lanes, 7] tensor (`pack_state`):
prev_backlog, growth_run (int32 bits), cum_arrived, cum_processed,
cum_failed, cum_missed, cum_shed; `tap_scan` updates it in place.

Rounding is the contract: every operation is one float32 IEEE operation
in the order above (the running sums are sequential, so no prefix sum of
the card computes them), and the kernel in `csrc/tap_scan.cu` rounds as
the plain version does, bitwise.

The probe's per-slot sums are the other kernel here: `tap_probe` writes
slot t of the tape's series (`dispatched` = the landings summed over M
per cloud, `arrived`, the named totals such as `retry_depth`, and the
backlog, its parts' totals added left to right) in one launch, every sum
in XLA:CPU's compiled order (`numerics.sum_plan`), so the series are
JAX's bits past 2**24 too. A `ProbePlan` fixes a run's sums once.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.numerics import plan_sum, sum_plan
from repro_torch.telemetry.monitors import K
from repro_torch.telemetry.taps import (
    GAUGES,
    RECORDS,
    TapSeries,
    TapState,
    Telemetry,
    TelemetryProbe,
    finalize_taps,
    step_taps,
)

# Launches of the CUDA kernels in this process (read by chip_smoke.py):
# tap_scan's and tap_probe's.
launches = 0
probe_launches = 0

MAX_T = 32 ** 4  # the kernel's XLA-order sums nest at most four window levels
I32, F32 = torch.int32, torch.float32
# the probe fields the recurrence reads (stale, int32, besides)
READ = ("emissions", "arrived", "processed", "failed", "wasted", "backlog", "clouds_down",
        "missed", "shed")


class TapOut(NamedTuple):
    """What `tap_scan` writes over a run: the recurrence's series over
    [0, T) (each call fills its slots) and, at the run's end, the gauges
    (`taps.GAUGES` order) and the alert records (`taps.RECORDS` order)."""

    backlog_growth: torch.Tensor         # [*lanes, T] f32
    conservation_residual: torch.Tensor  # [*lanes, T] f32
    alert_active: torch.Tensor           # [*lanes, T, K] int32
    gauges: torch.Tensor                 # [*lanes, 8] f32
    records: torch.Tensor                # [*lanes, 3, K] int32

    @classmethod
    def empty(cls, lanes: tuple, T: int, device) -> "TapOut":
        def z(*shape, dtype=F32):
            return torch.zeros(lanes + shape, dtype=dtype, device=device)

        return cls(z(T), z(T), z(T, K, dtype=I32), z(len(GAUGES)), z(len(RECORDS), K, dtype=I32))

    def series(self, probe: TelemetryProbe) -> TapSeries:
        """The run's TapSeries: the probe's fields and the scanned ones."""
        return TapSeries(*self.frame(probe)[:len(TapSeries._fields)])

    def frame(self, probe: TelemetryProbe) -> Telemetry:
        """The Telemetry frame of a run whose last slot has been scanned."""
        return Telemetry(
            emission_rate=probe.emissions, arrived=probe.arrived,
            dispatched_cloud=probe.dispatched, processed=probe.processed, failed=probe.failed,
            wasted=probe.wasted, backlog=probe.backlog, backlog_growth=self.backlog_growth,
            staleness=probe.stale, clouds_down=probe.clouds_down, retry_depth=probe.retry_depth,
            transfer_occupancy=probe.transfer_occupancy, missed=probe.missed, shed=probe.shed,
            conservation_residual=self.conservation_residual, alert_active=self.alert_active,
            **{g: self.gauges[..., i] for i, g in enumerate(GAUGES)},
            **{r: self.records[..., i, :] for i, r in enumerate(RECORDS)},
        )


def pack_state(tap: TapState) -> torch.Tensor:
    """A TapState as the packed float32 [*lanes, 7] tensor."""
    return torch.stack([tap.prev_backlog, tap.growth_run.to(I32).view(F32), *tap[2:]], dim=-1)


def unpack_state(packed: torch.Tensor) -> TapState:
    return TapState(packed[..., 0], packed[..., 1].contiguous().view(I32),
                    *(packed[..., i] for i in range(2, 7)))


def _slot(probe: TelemetryProbe, t: int) -> TelemetryProbe:
    return TelemetryProbe(*(x[..., t, :] if name == "dispatched" else x[..., t]
                            for name, x in zip(TelemetryProbe._fields, probe)))


def tap_scan_plain(cfg, probe: TelemetryProbe, out: TapOut, state: torch.Tensor, t0: int,
                   t1: int) -> None:
    """Slots t0..t1-1 through the port's `step_taps`, one at a time,
    then, when t1 is the run's end, `finalize_taps` over the whole run;
    writes into `out` and `state` (on the inputs' device)."""
    T = probe.backlog.shape[-1]
    tap = unpack_state(state)
    for t in range(t0, t1):
        tap, row = step_taps(cfg, tap, _slot(probe, t))
        out.backlog_growth[..., t] = row.backlog_growth
        out.conservation_residual[..., t] = row.conservation_residual
        out.alert_active[..., t, :] = row.alert_active
    state.copy_(pack_state(tap))
    if t1 == T:
        tel = finalize_taps(cfg, out.series(probe))
        out.gauges.copy_(torch.stack([getattr(tel, g) for g in GAUGES], dim=-1))
        out.records.copy_(torch.stack([getattr(tel, r) for r in RECORDS], dim=-2))


def _lib():
    lib = build.load("tap_scan")
    if lib.tap_scan_launch.argtypes is None:
        lib.tap_scan_launch.argtypes = (
            [ctypes.c_void_p] * 10          # the nine float32 series, stale
            + [ctypes.c_void_p] * 6         # growth, residual, active, gauges, records, state
            + [ctypes.c_int] * 4            # lanes, T, t0, t1
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
               ctypes.c_float, ctypes.c_float]  # the config and n_clouds
            + [ctypes.c_void_p])
        lib.tap_scan_launch.restype = ctypes.c_int
    return lib


def _check(name, x, shape, dtype, device, what="tap_scan"):
    if x.dtype != dtype or x.device != device or tuple(x.shape) != shape or \
            not x.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be contiguous {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")


def tap_scan_cuda(cfg, probe: TelemetryProbe, out: TapOut, state: torch.Tensor, t0: int,
                  t1: int) -> None:
    """Launches csrc/tap_scan.cu on PyTorch's current stream: a block a
    lane walks slots t0..t1-1 (and the run's reductions when t1 = T).
    Every tensor must be contiguous on the card; nothing is read back to
    the host."""
    global launches
    dev = probe.backlog.device
    *lead, T = probe.backlog.shape
    lead = tuple(lead)
    if not 0 <= t0 < t1 <= T or T > MAX_T:
        raise ValueError(f"tap_scan: slots [{t0}, {t1}) of a run of T={T} (at most {MAX_T})")
    for name in READ:
        _check(name, getattr(probe, name), lead + (T,), F32, dev)
    _check("stale", probe.stale, lead + (T,), I32, dev)
    _check("backlog_growth", out.backlog_growth, lead + (T,), F32, dev)
    _check("conservation_residual", out.conservation_residual, lead + (T,), F32, dev)
    _check("alert_active", out.alert_active, lead + (T, K), I32, dev)
    _check("gauges", out.gauges, lead + (len(GAUGES),), F32, dev)
    _check("records", out.records, lead + (len(RECORDS), K), I32, dev)
    _check("state", state, lead + (7,), F32, dev)
    lib = _lib()
    c = lambda v: ctypes.c_float(float(np.float32(v)))  # noqa: E731  the value JAX compares with
    status = lib.tap_scan_launch(
        *(getattr(probe, n).data_ptr() for n in READ), probe.stale.data_ptr(),
        *(x.data_ptr() for x in out), state.data_ptr(),
        math.prod(lead), T, t0, t1,
        c(cfg.growth_thresh), int(cfg.growth_sustain), int(cfg.stale_budget), c(cfg.drift_tol),
        c(cfg.miss_tol), c(cfg.shed_frac), c(probe.dispatched.shape[-1]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "tap_scan")
    launches += 1


# ---------------------------------------------------------------- the probe

PROBE_JOBS, PROBE_LEVELS, PROBE_PARTS = 6, 5, 4  # the kernel's argument block's room
# the kernel's geometry (csrc/tap_probe.cu): threads a block, a warp's ring
# rows, the most windows a warp streams side by side, and the warps the wide
# first passes are spread over, about
PROBE_THREADS, PROBE_RING_ROWS, PROBE_MAX_P, PROBE_CHAIN_WARPS = 256, 64, 8, 2048
PROBE_WARPS = PROBE_THREADS // 32
PROBE_GROUP_COLS = 32  # a sum by column's columns a group


class _Level(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("rows", "cols", "w0", "w1", "lo0", "lo1", "o0", "o1",
                                            "lanes", "nvec", "last_col")]


class _Job(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("out_lane", ctypes.c_longlong), ("out_t", ctypes.c_longlong),
                ("scratch", ctypes.c_void_p * PROBE_LEVELS), ("nlev", ctypes.c_int),
                ("lev", _Level * PROBE_LEVELS), ("task0", ctypes.c_int), ("ntask", ctypes.c_int),
                ("per_task", ctypes.c_int), ("P", ctypes.c_int), ("D", ctypes.c_int),
                ("cw", ctypes.c_int), ("groups", ctypes.c_int), ("count0", ctypes.c_int)]


class _Probe(ctypes.Structure):
    _fields_ = [("job", _Job * PROBE_JOBS), ("njobs", ctypes.c_int), ("lanes", ctypes.c_int),
                ("nparts", ctypes.c_int), ("t", ctypes.c_int), ("count_backlog", ctypes.c_int),
                ("part", ctypes.c_int * PROBE_PARTS), ("backlog", ctypes.c_void_p),
                ("backlog_lane", ctypes.c_longlong), ("backlog_t", ctypes.c_longlong),
                ("count", ctypes.c_void_p)]


class FirstPass(NamedTuple):
    """How one `tap_probe` launch splits a sum's first pass: its windows
    in groups of a lane's (cw = 0) or, for a sum by column, of cw of a
    lane's columns (`groups` a lane), each group's row-major, the groups
    in order; blocks task0 .. task0 + ntask - 1 take `per_task` of them
    each: a block's 256 threads a one-column window each, or its 8 warps
    P wide windows each, P lanes adding side by side, their rows streamed
    D rows ahead of the adds (D = 0: staged whole). The block that
    completes a group's first pass takes its upper passes."""

    task0: int
    ntask: int
    per_task: int
    P: int
    D: int
    cw: int
    groups: int


def streams(v) -> bool:
    """Whether the kernel streams a first pass's wide windows row by row:
    windows of 32 x 32 whole columns (rows of 32 values added in order, no
    lanes, no padded column)."""
    return v.w0 == 32 and v.w1 == 32 and v.cols % 32 == 0


def probe_schedule(plans, n_lanes: int) -> tuple:
    """The first passes' split (a `FirstPass` a sum, in the plans' order)
    of one launch over `n_lanes` lanes: the wide passes' tasks first, so
    that their chains start first, then the one-column passes'. P is the
    power of two that spreads all wide windows over about
    PROBE_CHAIN_WARPS warps (1 to PROBE_MAX_P), D the rows a warp's ring
    holds for each (16, or 8 at P = 8); a wide pass that does not stream
    takes at most 2 windows a warp, staged whole one at a time. A sum by
    column's groups are of PROBE_GROUP_COLS columns, so that its upper
    passes run in several blocks, as their first passes complete."""
    firsts = [plan.levels[0] for plan in plans]
    cws = [min(PROBE_GROUP_COLS, v.o1) if plan.by_column else 0
           for plan, v in zip(plans, firsts)]
    groups = [-(-v.o1 // cw) if cw else 1 for v, cw in zip(firsts, cws)]
    windows = [n_lanes * g * v.o0 * (cw or v.o1) for v, cw, g in zip(firsts, cws, groups)]
    if max(windows) >= 2 ** 31:
        raise ValueError(f"tap_probe: a pass of {max(windows)} windows (at most 2**31 - 1)")
    wide = sum(n for n, v in zip(windows, firsts) if v.w1 > 1)
    P = min(PROBE_MAX_P, 1 << max(0, math.ceil(wide / PROBE_CHAIN_WARPS) - 1).bit_length())
    out, task0 = [None] * len(plans), 0
    for k in sorted(range(len(plans)), key=lambda k: firsts[k].w1 == 1):
        v = firsts[k]
        if v.w1 == 1:
            Pk, D, per_task = 1, 0, PROBE_THREADS
        else:
            Pk, D = (P, min(16, PROBE_RING_ROWS // P)) if streams(v) else \
                (min(P, PROBE_RING_ROWS // 32), 0)
            per_task = PROBE_WARPS * Pk
        ntask = -(-windows[k] // per_task)
        out[k] = FirstPass(task0, ntask, per_task, Pk, D, cws[k], groups[k])
        task0 += ntask
    return tuple(out)


class ProbePlan:
    """The sums one `tap_probe` launch takes each slot of a run of T
    slots, fixed for the run: each input ({name: a slot's [*lanes, rows]
    or [*lanes, rows, cols] tensor}) is summed, in XLA:CPU's order, over
    all its axes after the lanes or, for the names in `by_column`, over
    its rows per column, into slot t of `outputs[name]` ([*lanes, T], by
    column [*lanes, T, cols]; an input without one is a backlog part
    only); `backlog[..., t]` is the totals of the inputs named in `parts`
    added left to right. `example` gives the inputs' shapes."""

    def __init__(self, lanes: tuple, T: int, example: dict, outputs: dict, parts=(),
                 backlog=None, by_column=()):
        if len(example) > PROBE_JOBS or len(parts) > PROBE_PARTS:
            raise ValueError(f"tap_probe: at most {PROBE_JOBS} sums and {PROBE_PARTS} parts")
        if parts and backlog is None:
            raise ValueError("tap_probe: backlog parts need a backlog series")
        if set(parts) & set(by_column):
            raise ValueError("tap_probe: a backlog part is a total, not a sum by column")
        self.lanes, self.T = tuple(lanes), T
        self.names = tuple(example)
        self.shapes = {n: tuple(x.shape) for n, x in example.items()}
        self.by_column = frozenset(by_column)
        self.plans = {}
        for n, shape in self.shapes.items():
            slab = shape[len(self.lanes):]
            if shape[:len(self.lanes)] != self.lanes or len(slab) not in (1, 2) or \
                    (n in self.by_column and len(slab) != 2):
                raise ValueError(f"tap_probe: {n} {shape} is not [*{self.lanes}, rows(, cols)]")
            self.plans[n] = sum_plan(slab[0], slab[1] if len(slab) == 2 else 1, n in self.by_column)
            if len(self.plans[n].levels) > PROBE_LEVELS:
                raise ValueError(f"tap_probe: {n} {shape} needs more than {PROBE_LEVELS} passes")
        self.schedule = probe_schedule([self.plans[n] for n in self.names], math.prod(self.lanes))
        self.outputs = dict(outputs)
        self.parts, self.backlog = tuple(parts), backlog
        self._args = None  # the kernel's argument block, made at the first launch

    def longest_chain(self) -> int:
        """The plan's longest chain of dependent adds, its sums' passes
        and the backlog's adds after them: a window of w0 x w1 values is
        w0 w1 adds, or (first / lanes) w1 + log2(lanes) + (w0 - first) w1
        where the vectorizer split it into lanes."""
        def chain(name):
            n = 0
            for v in self.plans[name].levels:
                first = v.nvec // v.lanes * v.lanes if v.lanes > 1 else 0
                n += first // v.lanes * v.w1 + (v.lanes.bit_length() - 1) + (v.w0 - first) * v.w1
            return n

        return max([chain(n) for n in self.names] +
                   [chain(p) + len(self.parts) - max(j, 1) for j, p in enumerate(self.parts)])

    @property
    def device(self):
        """The device of the series the plan writes."""
        return (self.backlog if self.backlog is not None else
                next(iter(self.outputs.values()))).device

    def args(self):
        """The CUDA kernel's argument block (scratch buffers and the
        counters allocated here, once for the run, the counters zeroed;
        the per-slot sources and t are set at each launch) and its
        blocks."""
        if self._args is not None:
            return self._args
        device = self.device
        n_lanes = math.prod(self.lanes)
        a = _Probe()
        keep, n_count = [], 0
        for k, name in enumerate(self.names):
            plan, job = self.plans[name], a.job[k]
            for i, v in enumerate(plan.levels):
                job.lev[i] = _Level(*v[:10], int(v.last_col))
                if i < len(plan.levels) - 1:
                    buf = torch.empty(n_lanes * v.o0 * v.o1, dtype=F32, device=device)
                    keep.append(buf)
                    job.scratch[i] = buf.data_ptr()
            job.nlev = len(plan.levels)
            (job.task0, job.ntask, job.per_task, job.P, job.D, job.cw,
             job.groups) = self.schedule[k]
            job.count0 = n_count
            n_count += n_lanes * job.groups
            out = self.outputs.get(name)
            if out is None:  # a backlog part only: its totals in a scratch row
                out = torch.empty(n_lanes, dtype=F32, device=device)
                keep.append(out)
                job.out, job.out_lane, job.out_t = out.data_ptr(), 1, 0
            else:
                col = name in self.by_column
                want = self.lanes + (self.T,) + ((self.shapes[name][-1],) if col else ())
                _check(f"output {name}", out, want, F32, device, "tap_probe")
                job.out, job.out_t = out.data_ptr(), out.stride(-2 if col else -1)
                job.out_lane = job.out_t * self.T
        if self.parts:
            _check("backlog", self.backlog, self.lanes + (self.T,), F32, device, "tap_probe")
            for i, p in enumerate(self.parts):
                a.part[i] = self.names.index(p)
            a.backlog, a.backlog_lane, a.backlog_t = self.backlog.data_ptr(), self.T, 1
        # a count a job's group, then a lane's: zeroed once, each reset by the
        # block that completes it
        a.count_backlog = n_count
        count = torch.zeros(n_count + n_lanes, dtype=torch.int32, device=device)
        keep.append(count)
        a.count = count.data_ptr()
        a.njobs, a.lanes, a.nparts = len(self.names), n_lanes, len(self.parts)
        blocks = sum(s.ntask for s in self.schedule)
        self._args = (a, blocks, keep, device)
        return self._args


def tap_probe_plain(plan: ProbePlan, t: int, inputs: dict) -> None:
    """Slot t of the plan's series from a slot's inputs, each sum a
    chain of elementwise float32 adds in XLA:CPU's order (on the inputs'
    device)."""
    nl = len(plan.lanes)
    totals = {}
    for name in plan.names:
        x = inputs[name]
        s = plan_sum(x if x.dim() - nl == 2 else x[..., None], plan.plans[name])
        totals[name] = s
        out = plan.outputs.get(name)
        if out is not None:
            if name in plan.by_column:
                out[..., t, :] = s
            else:
                out[..., t] = s
    if plan.parts:
        acc = totals[plan.parts[0]]
        for p in plan.parts[1:]:
            acc = acc + totals[p]
        plan.backlog[..., t] = acc


def _probe_lib():
    lib = build.load("tap_probe")
    if lib.tap_probe_launch.argtypes is None:
        lib.tap_probe_size.restype = ctypes.c_int
        if lib.tap_probe_size() != ctypes.sizeof(_Probe):
            raise RuntimeError(f"tap_probe: the kernel's argument block is {lib.tap_probe_size()} "
                               f"bytes, the wrapper's {ctypes.sizeof(_Probe)}")
        lib.tap_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.tap_probe_launch.restype = ctypes.c_int
    return lib


def tap_probe_cuda(plan: ProbePlan, t: int, inputs: dict) -> None:
    """Launches csrc/tap_probe.cu on PyTorch's current stream: every sum
    of slot t in one launch, into the plan's series. The inputs must be
    contiguous float32 on the card at the plan's shapes."""
    global probe_launches
    a, blocks, _, dev = plan.args()
    if not 0 <= t < plan.T:
        raise ValueError(f"tap_probe: slot {t} of a run of T={plan.T}")
    for k, name in enumerate(plan.names):
        x = inputs[name]
        if x.dtype != F32 or x.device != dev or tuple(x.shape) != plan.shapes[name] or \
                not x.is_contiguous():
            raise ValueError(f"tap_probe: {name} must be contiguous {F32} {plan.shapes[name]} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        a.job[k].src = x.data_ptr()
    a.t = t
    lib = _probe_lib()
    status = lib.tap_probe_launch(ctypes.addressof(a), blocks,
                                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "tap_probe")
    probe_launches += 1
