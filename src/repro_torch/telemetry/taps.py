"""Metrics taps: the telemetry state machine (counterpart of
`repro.telemetry.taps`).

The JAX package runs `step_taps` inside its scan body every slot. The
port's loops record only the probe's raw fields each slot (most of them
sums the loop keeps anyway) into a `core.simulator.TapTape`, and after
the run one `kernels.ops.tap_scan` launch walks the recurrence below and
the reductions of `finalize_taps` over the whole series. This module
holds the plain per-slot step, in JAX's float32 order, which the
kernel's plain version (`kernels.taps.tap_scan_plain`) loops over.

* `telemetry=None` runs record no tape and launch nothing more: every
  field is bitwise the run without the argument.
* The frame is the same in every record mode: the probe rides the
  per-slot series, which every mode records in full.

Every tensor may carry leading lane axes (a fleet): the series are then
[*lanes, T], the gauges [*lanes] and the alert records [*lanes, K].
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.numerics import xla_sum
from repro_torch.telemetry.monitors import MONITORS, f32, monitor_conditions

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Monitor thresholds. Frozen and hashable, as the JAX config is.

    growth_thresh   backlog delta per slot that counts as "growing"
    growth_sustain  consecutive growing slots before the alert trips
    stale_budget    carbon-signal age (slots) the run tolerates
    drift_tol       |conservation residual| tolerance (tasks)
    miss_tol        deadline misses per slot the SLO tolerates
    shed_frac       shed fraction of arrivals the SLO tolerates
    """

    growth_thresh: float = 0.0
    growth_sustain: int = 8
    stale_budget: int = 4
    drift_tol: float = 0.5
    miss_tol: float = 0.0
    shed_frac: float = 0.0


class TelemetryProbe(NamedTuple):
    """What one slot exposes to the taps. float32 unless noted; fields
    that do not apply to a loop are zeros. Stacked over a run (the
    loops' tape), every field gains a slot axis after the lanes."""

    emissions: torch.Tensor           # C(t) at true intensities
    arrived: torch.Tensor             # tasks arriving at the edge
    dispatched: torch.Tensor          # [..., N] tasks landing in each cloud queue
    processed: torch.Tensor           # processing attempts (post service mask)
    failed: torch.Tensor              # attempts failed into the retry pool
    wasted: torch.Tensor              # carbon spent on failed attempts
    backlog: torch.Tensor             # post-step Qe+Qc[+Qt][+retry] total
    stale: torch.Tensor               # int32 carbon-signal age seen by policy
    clouds_down: torch.Tensor         # clouds at zero capacity this slot
    retry_depth: torch.Tensor         # retry-pool total (post-step)
    transfer_occupancy: torch.Tensor  # in-flight transfer queue total
    missed: torch.Tensor              # tasks expired past deadline
    shed: torch.Tensor                # arrivals rejected by admission


class TapState(NamedTuple):
    """The carried accumulators (float32, growth_run int32), [*lanes]."""

    prev_backlog: torch.Tensor   # for the growth-rate series
    growth_run: torch.Tensor     # consecutive-growth counter
    cum_arrived: torch.Tensor    # running totals for the
    cum_processed: torch.Tensor  #   conservation residual
    cum_failed: torch.Tensor
    cum_missed: torch.Tensor
    cum_shed: torch.Tensor


class TapSeries(NamedTuple):
    """Per-slot tap outputs (stacked to [..., T, ...] over a run)."""

    emission_rate: torch.Tensor
    arrived: torch.Tensor
    dispatched_cloud: torch.Tensor       # [..., N]
    processed: torch.Tensor
    failed: torch.Tensor
    wasted: torch.Tensor
    backlog: torch.Tensor
    backlog_growth: torch.Tensor         # backlog delta vs previous slot
    staleness: torch.Tensor              # int32
    clouds_down: torch.Tensor
    retry_depth: torch.Tensor
    transfer_occupancy: torch.Tensor
    missed: torch.Tensor
    shed: torch.Tensor
    conservation_residual: torch.Tensor
    alert_active: torch.Tensor           # [..., K] int32, axis = MONITORS


class Telemetry(NamedTuple):
    """The exported frame: `TapSeries` stacked over T plus run gauges
    and the alert records. Under `simulate_fleet` every field carries a
    leading [F] axis (see `lane`)."""

    # per-slot series [..., T, ...]
    emission_rate: torch.Tensor
    arrived: torch.Tensor
    dispatched_cloud: torch.Tensor       # [..., T, N]
    processed: torch.Tensor
    failed: torch.Tensor
    wasted: torch.Tensor
    backlog: torch.Tensor
    backlog_growth: torch.Tensor
    staleness: torch.Tensor              # [..., T] int32
    clouds_down: torch.Tensor
    retry_depth: torch.Tensor
    transfer_occupancy: torch.Tensor
    missed: torch.Tensor
    shed: torch.Tensor
    conservation_residual: torch.Tensor
    alert_active: torch.Tensor           # [..., T, K] int32
    # run gauges and counters (float32, [...])
    peak_backlog: torch.Tensor
    total_emissions: torch.Tensor
    total_arrived: torch.Tensor
    total_processed: torch.Tensor
    total_failed: torch.Tensor
    total_wasted: torch.Tensor
    total_missed: torch.Tensor
    total_shed: torch.Tensor
    # alert records ([..., K] int32, axis = MONITORS)
    alert_tripped: torch.Tensor
    alert_first_slot: torch.Tensor       # first firing slot, -1 = never
    alert_count: torch.Tensor            # number of firing slots


# the gauges in the order the tap kernel writes them; every one but the
# peak is a float32 sum over the run in XLA:CPU's order (`xla_sum`)
GAUGES = ("peak_backlog", "total_emissions", "total_arrived", "total_processed",
          "total_failed", "total_wasted", "total_missed", "total_shed")
# the series each total sums
TOTALED = {"total_emissions": "emission_rate", "total_arrived": "arrived",
           "total_processed": "processed", "total_failed": "failed",
           "total_wasted": "wasted", "total_missed": "missed", "total_shed": "shed"}
# the alert records in the order the tap kernel writes them
RECORDS = ("alert_tripped", "alert_first_slot", "alert_count")


def init_taps(lanes: tuple = (), device=DEFAULT_DEVICE) -> TapState:
    device = resolve_device(device)
    z = torch.zeros(lanes, dtype=torch.float32, device=device)
    return TapState(prev_backlog=z, growth_run=torch.zeros(lanes, dtype=I32, device=device),
                    cum_arrived=z, cum_processed=z, cum_failed=z, cum_missed=z, cum_shed=z)


def step_taps(cfg: TelemetryConfig, tap: TapState, probe: TelemetryProbe) -> tuple:
    """One slot of tap accounting: (TapState, TapSeries), each float32
    operation rounded as JAX rounds it."""
    growth = probe.backlog - tap.prev_backlog
    growth_run = torch.where(growth > f32(cfg.growth_thresh, growth), tap.growth_run + 1,
                             0).to(I32)
    cum_arrived = tap.cum_arrived + probe.arrived
    cum_processed = tap.cum_processed + probe.processed
    cum_failed = tap.cum_failed + probe.failed
    cum_missed = tap.cum_missed + probe.missed
    cum_shed = tap.cum_shed + probe.shed
    # With deadlines off the trailing subtractions take away +0.0, as the
    # JAX residual does, so its bits are the pre-deadline residual's.
    residual = cum_arrived - (probe.backlog + cum_processed - cum_failed) - cum_missed - cum_shed
    active = monitor_conditions(cfg, probe, growth_run, residual)
    nxt = TapState(prev_backlog=probe.backlog, growth_run=growth_run, cum_arrived=cum_arrived,
                   cum_processed=cum_processed, cum_failed=cum_failed, cum_missed=cum_missed,
                   cum_shed=cum_shed)
    series = TapSeries(
        emission_rate=probe.emissions, arrived=probe.arrived, dispatched_cloud=probe.dispatched,
        processed=probe.processed, failed=probe.failed, wasted=probe.wasted,
        backlog=probe.backlog, backlog_growth=growth, staleness=probe.stale,
        clouds_down=probe.clouds_down, retry_depth=probe.retry_depth,
        transfer_occupancy=probe.transfer_occupancy, missed=probe.missed, shed=probe.shed,
        conservation_residual=residual, alert_active=active,
    )
    return nxt, series


def peak_of(backlog: torch.Tensor) -> torch.Tensor:
    """jnp.max over the last axis as XLA computes it: -0 below +0 (a +0
    anywhere beats every -0), and a NaN anywhere gives NaN (0x7fc00000
    here, so the card's plain version and its kernel agree bitwise)."""
    m = torch.amax(backlog, dim=-1)
    pos0 = ((backlog == 0) & ~torch.signbit(backlog)).any(dim=-1)
    m = torch.where((m == 0) & pos0, 0.0, m)
    return torch.where(torch.isnan(m), math.nan, m)


def finalize_taps(cfg: TelemetryConfig, series: TapSeries) -> Telemetry:
    """Reduces the stacked [..., T, ...] series into the Telemetry frame:
    the peak (`peak_of`), the totals over T in XLA:CPU's order (a
    reduce-window of SUM_BLOCK slots while more remain, see
    `kernels.numerics.xla_sum`), and the alert records, int32
    throughout."""
    active = series.alert_active                                  # [..., T, K]
    count = torch.sum(active, dim=-2, dtype=I32)
    first = torch.where(count > 0, torch.argmax(active, dim=-2).to(I32), -1).to(I32)
    totals = {g: xla_sum(getattr(series, s)[..., None]) for g, s in TOTALED.items()}
    return Telemetry(
        **{f: getattr(series, f) for f in TapSeries._fields},
        peak_backlog=peak_of(series.backlog),
        **totals,
        alert_tripped=(count > 0).to(I32),
        alert_first_slot=first,
        alert_count=count,
    )


def lane(frame: Telemetry, i: int) -> Telemetry:
    """Lane i of a fleet Telemetry frame ([F, ...] -> [...])."""
    return Telemetry(*(x[i] for x in frame))


class MetricSpec(NamedTuple):
    """Registry row: how a Telemetry field exports."""

    field: str  # Telemetry field name
    kind: str   # "series" | "gauge" | "counter"
    unit: str
    help: str


# The typed registry the exporters iterate, as the JAX package's. Alert
# fields are exported separately (one labelled metric per monitor).
METRICS = (
    MetricSpec("emission_rate", "series", "gCO2/slot",
               "per-slot carbon emissions at true intensities"),
    MetricSpec("arrived", "series", "tasks/slot",
               "tasks arriving at the edge"),
    MetricSpec("dispatched_cloud", "series", "tasks/slot",
               "tasks landing in each cloud queue"),
    MetricSpec("processed", "series", "tasks/slot",
               "processing attempts (post service mask)"),
    MetricSpec("failed", "series", "tasks/slot",
               "attempts failed into the retry pool"),
    MetricSpec("wasted", "series", "gCO2/slot",
               "carbon spent on failed attempts"),
    MetricSpec("backlog", "series", "tasks",
               "post-step total backlog Qe+Qc[+Qt][+retry]"),
    MetricSpec("backlog_growth", "series", "tasks/slot",
               "backlog delta vs previous slot"),
    MetricSpec("staleness", "series", "slots",
               "carbon-signal age seen by the policy"),
    MetricSpec("clouds_down", "series", "clouds",
               "clouds at zero capacity"),
    MetricSpec("retry_depth", "series", "tasks",
               "retry-pool total"),
    MetricSpec("transfer_occupancy", "series", "tasks",
               "in-flight WAN transfer total"),
    MetricSpec("missed", "series", "tasks/slot",
               "tasks expired past their deadline"),
    MetricSpec("shed", "series", "tasks/slot",
               "arrivals rejected by admission control"),
    MetricSpec("conservation_residual", "series", "tasks",
               "flow-conservation residual (should be ~0)"),
    MetricSpec("peak_backlog", "gauge", "tasks",
               "max backlog over the run"),
    MetricSpec("total_emissions", "counter", "gCO2",
               "cumulative carbon over the run"),
    MetricSpec("total_arrived", "counter", "tasks",
               "tasks arrived over the run"),
    MetricSpec("total_processed", "counter", "tasks",
               "processing attempts over the run"),
    MetricSpec("total_failed", "counter", "tasks",
               "failed attempts over the run"),
    MetricSpec("total_wasted", "counter", "gCO2",
               "carbon wasted on failed attempts over the run"),
    MetricSpec("total_missed", "counter", "tasks",
               "deadline misses over the run"),
    MetricSpec("total_shed", "counter", "tasks",
               "arrivals shed over the run"),
)

__all__ = [
    "MONITORS",
    "METRICS",
    "MetricSpec",
    "TelemetryConfig",
    "TelemetryProbe",
    "TapState",
    "TapSeries",
    "Telemetry",
    "init_taps",
    "step_taps",
    "finalize_taps",
    "lane",
]
