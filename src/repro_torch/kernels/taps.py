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
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
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

# Launches of the CUDA kernel in this process (read by chip_smoke.py).
launches = 0

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


def _check(name, x, shape, dtype, device):
    if x.dtype != dtype or x.device != device or tuple(x.shape) != shape or \
            not x.is_contiguous():
        raise ValueError(
            f"tap_scan: {name} must be contiguous {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")


def tap_scan_cuda(cfg, probe: TelemetryProbe, out: TapOut, state: torch.Tensor, t0: int,
                  t1: int) -> None:
    """Launches csrc/tap_scan.cu on PyTorch's current stream: one thread
    a lane walks slots t0..t1-1 (and the run's reductions when t1 = T).
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
