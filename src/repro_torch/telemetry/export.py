"""Host-side exporters for recorded Telemetry frames (counterpart of
`repro.telemetry.export`; the same frame gives the same strings, byte
for byte).

Everything here runs on the host on numpy values: a frame's tensors are
copied off the card once (`_np`). The batch exporters run after the
run returns, so they can never perturb it. `follow_run` is the live
consumer for the opt-in streaming path (telemetry.stream): it
subscribes to a StreamChannel and re-renders the same wire formats
incrementally while the loop is still running.

Three wire formats, each with a parse-checking validator the tests and
the CI telemetry-smoke job run against real output:

* Prometheus text exposition (`to_prometheus`): run-end counters and
  gauges, alert state labelled by monitor, per-cloud dispatch labelled
  by cloud.
* JSON-lines events (`to_jsonl`): one `slot` event per slot, one
  `alert` event per tripped monitor, one terminal `summary` event.
* Chrome trace (`to_chrome_trace`): counter tracks for every scalar
  series plus duration events for alert windows -- load in Perfetto /
  chrome://tracing next to a `profile.trace_to` dump.

Fleet frames ([F, ...] leaves) reduce through `manifest`; the
per-slot exporters take a single lane (`taps.lane(frame, i)`).
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from repro_torch.telemetry.monitors import MONITORS
from repro_torch.telemetry.taps import METRICS, Telemetry

# Scalar per-slot series exported as event fields / counter tracks.
_SCALAR_SERIES = tuple(
    m.field for m in METRICS
    if m.kind == "series" and m.field != "dispatched_cloud"
)
_COUNTERS = tuple(m for m in METRICS if m.kind == "counter")
_GAUGES = tuple(m for m in METRICS if m.kind == "gauge")


def _np(x) -> np.ndarray:
    """A frame field as a numpy array (a tensor is copied to the host)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _host(frame):
    """Every field of a frame (or a TapSeries slice) as numpy."""
    return type(frame)(*(_np(x) for x in frame))


def _require_lane(frame: Telemetry) -> None:
    if np.asarray(frame.peak_backlog).ndim != 0:
        raise ValueError(
            "fleet frame: per-slot exporters take one lane -- select it "
            "with repro_torch.telemetry.lane(frame, i), or reduce the whole "
            "fleet with repro_torch.telemetry.manifest(frame)"
        )


def _prom_name(spec) -> str:
    # Prometheus counters end in _total by convention.
    if spec.kind == "counter":
        return "repro_" + spec.field.replace("total_", "") + "_total"
    return "repro_" + spec.field


def to_prometheus(frame: Telemetry) -> str:
    """Prometheus text exposition of the run-end state: counters,
    gauges, the final value of every scalar series, per-cloud dispatch
    totals, and the alert records labelled by monitor."""
    frame = _host(frame)
    _require_lane(frame)
    lines = []

    def emit(name, kind, help_, samples):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            lines.append(f"{name}{labels} {value:.10g}")

    for spec in _COUNTERS + _GAUGES:
        kind = "counter" if spec.kind == "counter" else "gauge"
        v = float(np.asarray(getattr(frame, spec.field)))
        emit(_prom_name(spec), kind, f"{spec.help} ({spec.unit})",
             [("", v)])
    for field in _SCALAR_SERIES:
        spec = next(m for m in METRICS if m.field == field)
        v = float(np.asarray(getattr(frame, field))[-1])
        emit(_prom_name(spec) + "_last", "gauge",
             f"final-slot {spec.help} ({spec.unit})", [("", v)])
    disp = np.asarray(frame.dispatched_cloud).sum(axis=0)
    emit("repro_dispatched_cloud_total", "counter",
         "tasks landed per cloud queue (tasks)",
         [(f'{{cloud="{n}"}}', float(disp[n]))
          for n in range(disp.shape[0])])
    for name, help_ in (
        ("repro_alert_tripped", "monitor fired at least once (bool)"),
        ("repro_alert_first_slot", "first firing slot (-1 = never)"),
        ("repro_alert_count", "number of firing slots"),
    ):
        arr = np.asarray(getattr(frame, name.replace("repro_", "")))
        emit(name, "gauge", help_,
             [(f'{{monitor="{mon}"}}', float(arr[k]))
              for k, mon in enumerate(MONITORS)])
    return "\n".join(lines) + "\n"


def to_jsonl(frame: Telemetry) -> str:
    """JSON-lines event stream: `slot` events (one per slot, every
    scalar series plus the per-cloud dispatch vector), `alert` events
    for tripped monitors, and a terminal `summary` event."""
    frame = _host(frame)
    _require_lane(frame)
    series = {f: np.asarray(getattr(frame, f)) for f in _SCALAR_SERIES}
    disp = np.asarray(frame.dispatched_cloud)
    active = np.asarray(frame.alert_active)
    T = disp.shape[0]
    out = []
    for t in range(T):
        ev = {"event": "slot", "t": t}
        for f, arr in series.items():
            ev[f] = float(arr[t])
        ev["dispatched_cloud"] = [float(x) for x in disp[t]]
        ev["alerts_active"] = [
            mon for k, mon in enumerate(MONITORS) if active[t, k]
        ]
        out.append(json.dumps(ev))
    tripped = np.asarray(frame.alert_tripped)
    first = np.asarray(frame.alert_first_slot)
    count = np.asarray(frame.alert_count)
    for k, mon in enumerate(MONITORS):
        if tripped[k]:
            out.append(json.dumps({
                "event": "alert", "monitor": mon,
                "first_slot": int(first[k]),
                "slots_active": int(count[k]),
            }))
    summary = {"event": "summary"}
    for spec in _COUNTERS + _GAUGES:
        summary[spec.field] = float(np.asarray(getattr(frame, spec.field)))
    out.append(json.dumps(summary))
    return "\n".join(out) + "\n"


def to_chrome_trace(frame: Telemetry, slot_us: float = 1000.0) -> str:
    """Chrome trace-event JSON: one counter track per scalar series
    (ph="C") and one duration event per contiguous alert window
    (ph="X"), slot t at timestamp t*slot_us. Loads in Perfetto /
    chrome://tracing."""
    frame = _host(frame)
    _require_lane(frame)
    events = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": "repro.telemetry"}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "series"}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 1,
         "args": {"name": "alerts"}},
    ]
    for field in _SCALAR_SERIES:
        arr = np.asarray(getattr(frame, field))
        for t in range(arr.shape[0]):
            events.append({
                "name": field, "ph": "C", "pid": 0, "tid": 0,
                "ts": t * slot_us, "args": {field: float(arr[t])},
            })
    active = np.asarray(frame.alert_active)
    for k, mon in enumerate(MONITORS):
        col = active[:, k]
        t = 0
        while t < col.shape[0]:
            if col[t]:
                start = t
                while t < col.shape[0] and col[t]:
                    t += 1
                events.append({
                    "name": f"alert:{mon}", "ph": "X", "cat": "alert",
                    "pid": 0, "tid": 1, "ts": start * slot_us,
                    "dur": (t - start) * slot_us,
                })
            else:
                t += 1
    return json.dumps(
        {"traceEvents": events, "displayTimeUnit": "ms"}
    )


def manifest(frame: Telemetry) -> dict:
    """Reduces a Telemetry frame (single-lane or fleet) to the plain
    JSON manifest the bench rows carry: peak backlog (max over lanes),
    emission/waste/failure totals (summed over lanes), and per-monitor
    alert records (lanes tripped, firing-slot total, earliest
    first-trip slot across lanes)."""
    K = len(MONITORS)
    frame = _host(frame)
    out = {
        "peak_backlog": float(np.max(np.asarray(frame.peak_backlog))),
        "total_emissions": float(
            np.sum(np.asarray(frame.total_emissions))
        ),
        "total_wasted": float(np.sum(np.asarray(frame.total_wasted))),
        "total_failed": float(np.sum(np.asarray(frame.total_failed))),
        "alerts": {},
    }
    tripped = np.asarray(frame.alert_tripped).reshape(-1, K)
    first = np.asarray(frame.alert_first_slot).reshape(-1, K)
    count = np.asarray(frame.alert_count).reshape(-1, K)
    for k, mon in enumerate(MONITORS):
        fs = first[:, k][first[:, k] >= 0]
        out["alerts"][mon] = {
            "tripped": int(tripped[:, k].sum()),
            "slots_active": int(count[:, k].sum()),
            "first_slot": int(fs.min()) if fs.size else -1,
        }
    return out


def oracle_gap_series(result, carbon_table, horizon=None):
    """Per-slot clairvoyant re-pricing of the run's energy profile:
    returns `(oracle_rate [T], gap [T])` float32 where `gap` is the
    realized per-slot emissions minus the windowed-min repriced cost of
    the same energy (the per-slot refinement of
    `core.extensions.oracle_emissions_horizon`: `oracle_rate.sum()`
    equals that bound on the tiled table). For WAN results the transfer
    term stays in `gap` un-repriced -- the oracle covers edge + cloud
    energy only. Host-side numpy on a finished result, like the oracle
    bounds themselves.
    """
    em = _np(result.emissions).astype(np.float64)
    T = em.shape[0]
    ci = _np(carbon_table).astype(np.float64)
    ci = ci[np.arange(T) % ci.shape[0]]
    H = T if horizon is None else int(min(max(horizon, 1), T))
    wmin = ci.copy()
    for h in range(1, H):
        np.minimum(wmin, np.roll(ci, -h, axis=0), out=wmin)
    ee = _np(result.energy_edge).astype(np.float64).reshape(T)
    ec = _np(result.energy_cloud).astype(np.float64).reshape(T, -1)
    oracle = ee * wmin[:, 0] + (ec * wmin[:, 1:]).sum(axis=1)
    return oracle.astype(np.float32), (em - oracle).astype(np.float32)


class FollowedRun:
    """Live consumer for a streaming run (see telemetry.stream).

    Subscribes to the named StreamChannel: every flushed TapSeries
    slice appends one JSONL `slot` event per slot (the same fields
    `to_jsonl` writes, plus the fleet `lane`) and rewrites a running
    Prometheus snapshot. `close()` detaches, appends the terminal
    `summary` event and returns the paths, so the live file passes the
    same `validate_jsonl` gate as batch output. With `outdir=None`
    nothing is written -- the object still accumulates totals and
    serves `series(lane)` (the bitwise reassembly of the batch
    TapSeries, delegated to the channel buffer).

    Flushes run on the simulating thread and lanes interleave: all
    mutation happens under one lock, and events are keyed by their
    payload (lane, t) rather than arrival order.
    """

    def __init__(self, channel_name: str = "default", outdir=None,
                 stem: str = "live"):
        import threading

        from repro_torch.telemetry.stream import channel

        self._channel = channel(channel_name)
        self._lock = threading.Lock()
        self._lanes: set = set()
        self._slots = 0
        self._flushes = 0
        self._totals = {
            "total_emissions": 0.0, "total_arrived": 0.0,
            "total_processed": 0.0, "total_failed": 0.0,
            "total_wasted": 0.0,
        }
        self._last_backlog: dict = {}
        self.paths: dict = {}
        if outdir is not None:
            outdir = Path(outdir)
            outdir.mkdir(parents=True, exist_ok=True)
            self.paths = {
                "jsonl": outdir / f"{stem}.jsonl",
                "prometheus": outdir / f"{stem}.prom",
            }
            self.paths["jsonl"].write_text("")
        self._closed = False
        self._channel.subscribe(self._on_flush)

    # -- consumer side -------------------------------------------------

    def _on_flush(self, lane: int, t0: int, slice_) -> None:
        slice_ = _host(slice_)
        T = np.asarray(slice_.arrived).shape[0]
        active = np.asarray(slice_.alert_active)
        events = []
        for i in range(T):
            ev = {"event": "slot", "lane": int(lane), "t": int(t0 + i)}
            for f in _SCALAR_SERIES:
                ev[f] = float(np.asarray(getattr(slice_, f))[i])
            ev["dispatched_cloud"] = [
                float(x) for x in np.asarray(slice_.dispatched_cloud)[i]
            ]
            ev["alerts_active"] = [
                mon for k, mon in enumerate(MONITORS) if active[i, k]
            ]
            events.append(json.dumps(ev))
        with self._lock:
            self._flushes += 1
            self._slots += T
            self._lanes.add(int(lane))
            self._totals["total_emissions"] += float(
                np.asarray(slice_.emission_rate).sum()
            )
            self._totals["total_arrived"] += float(
                np.asarray(slice_.arrived).sum()
            )
            self._totals["total_processed"] += float(
                np.asarray(slice_.processed).sum()
            )
            self._totals["total_failed"] += float(
                np.asarray(slice_.failed).sum()
            )
            self._totals["total_wasted"] += float(
                np.asarray(slice_.wasted).sum()
            )
            self._last_backlog[int(lane)] = float(
                np.asarray(slice_.backlog)[-1]
            )
            if self.paths:
                with self.paths["jsonl"].open("a") as fh:
                    fh.write("\n".join(events) + "\n")
                self.paths["prometheus"].write_text(
                    self._prometheus_locked()
                )

    def _prometheus_locked(self) -> str:
        lines = []

        def emit(name, kind, help_, samples):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                lines.append(f"{name}{labels} {value:.10g}")

        emit("repro_stream_flushes", "counter",
             "TapSeries slices flushed so far", [("", self._flushes)])
        emit("repro_stream_slots", "counter",
             "lane-slots streamed so far", [("", self._slots)])
        emit("repro_stream_lanes", "gauge",
             "fleet lanes seen so far", [("", len(self._lanes))])
        for key, val in self._totals.items():
            emit(f"repro_stream_{key.replace('total_', '')}_total",
                 "counter", f"running {key} over streamed slots",
                 [("", val)])
        emit("repro_stream_backlog_last", "gauge",
             "backlog at each lane's newest streamed slot",
             [(f'{{lane="{ln}"}}', v)
              for ln, v in sorted(self._last_backlog.items())])
        return "\n".join(lines) + "\n"

    # -- reader side ---------------------------------------------------

    def to_prometheus(self) -> str:
        with self._lock:
            return self._prometheus_locked()

    @property
    def slots(self) -> int:
        with self._lock:
            return self._slots

    def lanes(self):
        with self._lock:
            return sorted(self._lanes)

    def totals(self) -> dict:
        with self._lock:
            return dict(self._totals)

    def series(self, lane: int = 0):
        """The reassembled [T, ...] TapSeries for one lane (bitwise
        equal to the batch frame's series; see StreamChannel.series)."""
        return self._channel.series(lane)

    def close(self) -> dict:
        """Detaches from the channel, writes the terminal `summary`
        event + final Prometheus snapshot, and returns the paths."""
        if self._closed:
            return self.paths
        self._channel.unsubscribe(self._on_flush)
        self._closed = True
        with self._lock:
            if self.paths:
                summary = {
                    "event": "summary", "lanes": len(self._lanes),
                    "slots": self._slots, "flushes": self._flushes,
                    **self._totals,
                }
                with self.paths["jsonl"].open("a") as fh:
                    fh.write(json.dumps(summary) + "\n")
                self.paths["prometheus"].write_text(
                    self._prometheus_locked()
                )
        return self.paths

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def follow_run(channel: str = "default", outdir=None,
               stem: str = "live") -> FollowedRun:
    """Attaches a live consumer to a streaming channel: returns a
    FollowedRun already subscribed (use as a context manager around the
    run; see README §Watching a run, live mode)."""
    return FollowedRun(channel, outdir=outdir, stem=stem)


def write_run(frame: Telemetry, outdir, stem: str = "run") -> dict:
    """Writes all three wire formats for one lane; returns the paths."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    paths = {
        "prometheus": outdir / f"{stem}.prom",
        "jsonl": outdir / f"{stem}.jsonl",
        "chrome_trace": outdir / f"{stem}.trace.json",
    }
    paths["prometheus"].write_text(to_prometheus(frame))
    paths["jsonl"].write_text(to_jsonl(frame))
    paths["chrome_trace"].write_text(to_chrome_trace(frame))
    return paths


_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})?\s+[-+]?"
    r"([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|[Nn]a[Nn]|[Ii]nf)$"
)


def validate_prometheus(text: str) -> int:
    """Parse-checks Prometheus text exposition; returns sample count.
    Histogram samples use the conventional `<base>_bucket` /
    `<base>_sum` / `<base>_count` suffixes under one `TYPE <base>
    histogram` declaration."""
    samples = 0
    typed = set()
    histograms = set()
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) < 4 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"bad comment line {i + 1}: {line!r}")
            if parts[1] == "TYPE":
                typed.add(parts[2])
                if parts[3] == "histogram":
                    histograms.add(parts[2])
            continue
        if not _PROM_SAMPLE.match(line):
            raise ValueError(f"bad sample line {i + 1}: {line!r}")
        name = line.split("{")[0].split()[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in histograms:
            raise ValueError(f"sample before TYPE for {name!r}")
        samples += 1
    if samples == 0:
        raise ValueError("no samples")
    return samples


def validate_jsonl(text: str) -> int:
    """Parse-checks a JSON-lines event stream; returns event count."""
    events = 0
    kinds = set()
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        ev = json.loads(line)
        if "event" not in ev:
            raise ValueError(f"line {i + 1} missing 'event' field")
        kinds.add(ev["event"])
        events += 1
    if "slot" not in kinds or "summary" not in kinds:
        raise ValueError(f"missing slot/summary events (saw {kinds})")
    return events


def validate_chrome_trace(text: str) -> int:
    """Parse-checks Chrome trace-event JSON; returns event count."""
    doc = json.loads(text)
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents missing or empty")
    for i, ev in enumerate(events):
        if "ph" not in ev or "name" not in ev:
            raise ValueError(f"event {i} missing ph/name: {ev!r}")
        if ev["ph"] in ("C", "X") and "ts" not in ev:
            raise ValueError(f"event {i} missing ts: {ev!r}")
    return len(events)


def validate_dir(outdir, formats=("prom", "jsonl", "trace")) -> dict:
    """Validates every telemetry file under `outdir` (the CI
    telemetry-smoke gate); requires at least one file of each format
    in `formats` (default: all three). Live-mode directories carry no
    Chrome trace -- the serving-smoke gate passes
    `formats=("prom", "jsonl")`. Returns {path: event/sample count}."""
    outdir = Path(outdir)
    all_checks = {
        "prom": ("*.prom", validate_prometheus),
        "jsonl": ("*.jsonl", validate_jsonl),
        "trace": ("*.trace.json", validate_chrome_trace),
    }
    unknown = set(formats) - set(all_checks)
    if unknown:
        raise ValueError(f"unknown formats: {sorted(unknown)}")
    checks = {all_checks[f][0]: all_checks[f][1] for f in formats}
    out = {}
    for pattern, fn in checks.items():
        paths = sorted(outdir.glob(pattern))
        if not paths:
            raise ValueError(f"no {pattern} files under {outdir}")
        for p in paths:
            out[str(p)] = fn(p.read_text())
    return out
