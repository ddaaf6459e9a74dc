"""Telemetry: metrics taps, phase annotation, SLO monitors and host-side
exporters (counterpart of `repro.telemetry`).

Turn it on by passing `telemetry=TelemetryConfig()` to any simulator
(`simulate`, `simulate_network`, `simulate_faulted`,
`simulate_network_faulted`, `simulate_fleet`); the result's `telemetry`
field then carries a `Telemetry` frame of per-slot series, run gauges
and alert records, made by one `tap_scan` kernel launch after the run.
`telemetry=None` (the default) records and launches nothing more, and
every result field is bitwise the run without it.

Live mode: pass `telemetry=StreamConfig(flush_every=k)` instead and
attach a `follow_run` consumer -- TapSeries slices flush to a host
StreamChannel every k slots while the loop runs, feeding the same
Prometheus / JSONL formats incrementally.
"""
from repro_torch.telemetry.export import (
    FollowedRun,
    follow_run,
    manifest,
    oracle_gap_series,
    to_chrome_trace,
    to_jsonl,
    to_prometheus,
    validate_chrome_trace,
    validate_dir,
    validate_jsonl,
    validate_prometheus,
    write_run,
)
from repro_torch.telemetry.monitors import MONITORS, monitor_conditions
from repro_torch.telemetry.profile import PHASES, phase, trace_to
from repro_torch.telemetry.stream import (
    StreamChannel,
    StreamConfig,
    channel,
    reset_channel,
    split_telemetry,
)
from repro_torch.telemetry.taps import (
    METRICS,
    MetricSpec,
    TapSeries,
    TapState,
    Telemetry,
    TelemetryConfig,
    TelemetryProbe,
    finalize_taps,
    init_taps,
    lane,
    step_taps,
)

__all__ = [
    "MONITORS",
    "METRICS",
    "PHASES",
    "FollowedRun",
    "MetricSpec",
    "StreamChannel",
    "StreamConfig",
    "TapSeries",
    "TapState",
    "Telemetry",
    "TelemetryConfig",
    "TelemetryProbe",
    "channel",
    "finalize_taps",
    "follow_run",
    "init_taps",
    "lane",
    "manifest",
    "reset_channel",
    "split_telemetry",
    "monitor_conditions",
    "oracle_gap_series",
    "phase",
    "step_taps",
    "to_chrome_trace",
    "to_jsonl",
    "to_prometheus",
    "trace_to",
    "validate_chrome_trace",
    "validate_dir",
    "validate_jsonl",
    "validate_prometheus",
    "write_run",
]
