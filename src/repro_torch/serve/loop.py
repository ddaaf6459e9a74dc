"""Serving loop: slots decided one at a time as they land (counterpart
of `repro.serve.loop`, without the deadline layer).

`make_serve_step` returns the one serving step, which runs the same
per-slot body as `core.simulator.simulate` (`slot_step`, the same
`split(key, 3)`), so driving it over t = 0..T-1 reproduces the batch trajectory
bitwise. `serve_loop` drives it from the host and times every decision:
the wall time of one step, with `torch.cuda.synchronize()` before the
clock is read again, so a latency covers the device work and not only
its enqueueing. Percentiles (p50/p95/p99, `np.percentile` linear
interpolation) exclude the first `warmup` slots, which pay the kernel
build and first launches.

The clock is injectable (`clock=`) and is called once before the loop,
twice per slot and once after, so tests get deterministic histograms.
Every `flush_every` slots the JSONL event log grows one `slot` event per
slot and the Prometheus snapshot is rewritten; `close` appends the
terminal `summary` event, computed from the same per-slot values.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.queueing import NetworkSpec, NetworkState, init_state
from repro_torch.core.simulator import make_slot_loop, slot_step
from repro_torch.device import DEFAULT_DEVICE, resolve_device

# Latency histogram buckets (microseconds), Prometheus-style with a
# terminal +Inf bucket appended by the exporter.
LATENCY_BUCKETS_US = (
    50.0, 100.0, 200.0, 500.0, 1e3, 2e3, 5e3, 1e4, 2e4, 5e4, 1e5, 1e6,
)


class ServeReport(NamedTuple):
    """End-of-run summary of a `serve_loop` drive. Scalar fields are what
    the terminal JSONL `summary` event carries; the arrays are the full
    per-slot series behind them."""

    slots: int
    warmup: int            # leading slots excluded from percentiles
    tasks_arrived: float
    tasks_dispatched: float
    tasks_processed: float
    total_emissions: float
    wall_s: float
    tasks_per_sec: float   # arrived tasks / wall_s
    p50_us: float          # decision-latency percentiles over
    p95_us: float          #   slots[warmup:]
    p99_us: float
    mean_us: float
    max_queue_age: int     # slots; oldest unserved task over the run
    latency_us: np.ndarray  # [slots] every decision, warmup included
    backlog: np.ndarray     # [slots] post-step Qe+Qc total
    queue_age: np.ndarray   # [slots] oldest unserved task's age
    emissions: np.ndarray   # [slots] C(t), float32 as the device computed it
    state: NetworkState     # the queues after the last slot, on the device
    age_p50: float = 0.0    # queue-age percentiles over all slots
    age_p95: float = 0.0
    age_p99: float = 0.0


def latency_percentiles(lat_us) -> tuple:
    """(p50, p95, p99, mean) of a latency sample, `np.percentile` linear
    interpolation."""
    lat = np.asarray(lat_us, np.float64)
    p50, p95, p99 = (float(x) for x in np.percentile(lat, [50.0, 95.0, 99.0]))
    return p50, p95, p99, float(lat.mean())


def make_serve_step(policy, spec: NetworkSpec, carbon_source, arrival_source,
                    key=0, device=DEFAULT_DEVICE):
    """The serving step `(state, t) -> (state', metrics)`, metrics a [5]
    float32 tensor on the device: (emissions, arrived, dispatched,
    processed, backlog). One tensor, so the host reads a slot's metrics
    with one copy."""
    loop = make_slot_loop(policy, spec, carbon_source, arrival_source, key, device)

    def step(state: NetworkState, t: int):
        nxt, act, a, C_t = slot_step(loop, state, t)
        metrics = torch.stack([
            C_t,
            torch.sum(a),
            torch.sum(act.d),
            torch.sum(act.w),
            torch.sum(nxt.Qe) + torch.sum(nxt.Qc),
        ])
        return nxt, metrics

    return step


class _AgeFifo:
    """Host-side queue-age bookkeeping: arrivals enqueue (slot, count),
    processing attempts drain oldest-first; `age(t)` is the age of the
    oldest task still waiting (an upper-bound gauge: the device queues
    are per type and cloud, the FIFO is global)."""

    def __init__(self):
        self._fifo: list = []

    def update(self, t: int, arrived: float, processed: float) -> int:
        if arrived > 0:
            self._fifo.append([t, arrived])
        drain = processed
        while drain > 0 and self._fifo:
            head = self._fifo[0]
            take = min(head[1], drain)
            head[1] -= take
            drain -= take
            if head[1] <= 0:
                self._fifo.pop(0)
        return t - self._fifo[0][0] if self._fifo else 0


class ServeExporter:
    """Live Prometheus/JSONL writer for a serving run. Buffers slot events
    and flushes every `flush_every` slots: appends the events to
    `<stem>.jsonl` and rewrites `<stem>.prom`. `close(report)` appends
    the terminal `summary` event built from the ServeReport."""

    def __init__(self, outdir, stem: str = "serve", flush_every: int = 16, warmup: int = 2):
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        self.paths = {"jsonl": outdir / f"{stem}.jsonl", "prometheus": outdir / f"{stem}.prom"}
        self.paths["jsonl"].write_text("")
        self.flush_every = flush_every
        self.warmup = warmup
        self._pending: list = []
        self._slots = 0
        self._lat: list = []  # non-warmup latencies so far
        self._totals = {"arrived": 0.0, "dispatched": 0.0, "processed": 0.0, "emissions": 0.0}
        self._last = {"backlog": 0.0, "queue_age": 0}

    def record(self, t: int, latency_us: float, arrived: float, dispatched: float,
               processed: float, backlog: float, queue_age: int, emissions_t: float) -> None:
        self._pending.append(json.dumps({
            "event": "slot", "kind": "serve", "t": t,
            "latency_us": latency_us, "arrived": arrived,
            "dispatched": dispatched, "processed": processed,
            "backlog": backlog, "queue_age": queue_age,
            "emissions": emissions_t, "warmup": t < self.warmup,
        }))
        self._slots += 1
        if t >= self.warmup:
            self._lat.append(latency_us)
        self._totals["arrived"] += arrived
        self._totals["dispatched"] += dispatched
        self._totals["processed"] += processed
        self._totals["emissions"] += emissions_t
        self._last = {"backlog": backlog, "queue_age": queue_age}
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self._pending:
            with self.paths["jsonl"].open("a") as fh:
                fh.write("\n".join(self._pending) + "\n")
            self._pending = []
        self.paths["prometheus"].write_text(self._prometheus())

    def _prometheus(self) -> str:
        lines = []

        def emit(name, kind, help_, samples):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                lines.append(f"{name}{labels} {value:.10g}")

        emit("repro_serve_slots", "counter", "slots decided so far", [("", self._slots)])
        for k, v in self._totals.items():
            unit = "gCO2" if k == "emissions" else "tasks"
            emit(f"repro_serve_{k}_total", "counter", f"running {k} over served slots ({unit})",
                 [("", v)])
        emit("repro_serve_backlog", "gauge", "post-step backlog at the newest slot (tasks)",
             [("", self._last["backlog"])])
        emit("repro_serve_queue_age", "gauge",
             "oldest unserved task's age at the newest slot (slots)",
             [("", self._last["queue_age"])])
        if self._lat:
            lat = np.asarray(self._lat)
            p50, p95, p99, mean = latency_percentiles(lat)
            for q, v in (("p50", p50), ("p95", p95), ("p99", p99), ("mean", mean)):
                emit(f"repro_serve_latency_{q}_us", "gauge",
                     f"decision latency {q} over non-warmup slots (us)", [("", v)])
            name = "repro_serve_latency_us"
            lines.append(f"# HELP {name} decision latency (us)")
            lines.append(f"# TYPE {name} histogram")
            for b in LATENCY_BUCKETS_US:
                lines.append(f'{name}_bucket{{le="{b:g}"}} {int((lat <= b).sum())}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {lat.size}')
            lines.append(f"{name}_sum {lat.sum():.10g}")
            lines.append(f"{name}_count {lat.size}")
        return "\n".join(lines) + "\n"

    def close(self, report: ServeReport) -> dict:
        self.flush()
        summary = {
            "event": "summary", "kind": "serve",
            "slots": report.slots, "warmup": report.warmup,
            "tasks_arrived": report.tasks_arrived,
            "tasks_dispatched": report.tasks_dispatched,
            "tasks_processed": report.tasks_processed,
            "total_emissions": report.total_emissions,
            "wall_s": report.wall_s,
            "tasks_per_sec": report.tasks_per_sec,
            "p50_us": report.p50_us, "p95_us": report.p95_us,
            "p99_us": report.p99_us, "mean_us": report.mean_us,
            "max_queue_age": report.max_queue_age,
            "age_p50": report.age_p50, "age_p95": report.age_p95,
            "age_p99": report.age_p99,
        }
        with self.paths["jsonl"].open("a") as fh:
            fh.write(json.dumps(summary) + "\n")
        self.paths["prometheus"].write_text(self._prometheus())
        return self.paths


def serve_loop(policy, spec: NetworkSpec, carbon_source, arrival_source, T: int,
               key=0, *, warmup: int = 2, clock=None, outdir=None,
               stem: str = "serve", flush_every: int = 16,
               device=DEFAULT_DEVICE) -> ServeReport:
    """Drives `make_serve_step` for T slots from the host, timing every
    decision. `key` is an int seed (`PRNGKey(seed)`) or a threefry key.
    `clock` defaults to `time.perf_counter` (called 2T + 2 times).
    `outdir` turns on live export via ServeExporter. Percentiles cover
    slots[warmup:]; `warmup` is clamped to T-1."""
    if clock is None:
        clock = time.perf_counter
    warmup = max(0, min(warmup, T - 1))
    exporter = None
    if outdir is not None:
        exporter = ServeExporter(outdir, stem=stem, flush_every=flush_every, warmup=warmup)
    dev = resolve_device(device)
    step = make_serve_step(policy, spec, carbon_source, arrival_source, key, dev)
    state = init_state(spec.M, spec.N, device=dev)
    ages = _AgeFifo()
    lat = np.zeros(T)
    backlog = np.zeros(T)
    em = np.zeros(T, np.float32)
    queue_age = np.zeros(T, np.int64)
    totals = {"arrived": 0.0, "dispatched": 0.0, "processed": 0.0, "emissions": 0.0}

    t_start = clock()
    for t in range(T):
        c0 = clock()
        state, metrics = step(state, t)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        c1 = clock()
        lat[t] = (c1 - c0) * 1e6
        em_t, arrived, dispatched, processed, bl = metrics.tolist()
        totals["arrived"] += arrived
        totals["dispatched"] += dispatched
        totals["processed"] += processed
        totals["emissions"] += em_t
        backlog[t] = bl
        em[t] = em_t
        queue_age[t] = ages.update(t, arrived, processed)
        if exporter is not None:
            exporter.record(t, lat[t], arrived, dispatched, processed, bl,
                            int(queue_age[t]), em_t)
    wall_s = clock() - t_start

    p50, p95, p99, mean = latency_percentiles(lat[warmup:])
    age_p50, age_p95, age_p99 = (float(x) for x in np.percentile(queue_age, [50.0, 95.0, 99.0]))
    report = ServeReport(
        slots=T,
        warmup=warmup,
        tasks_arrived=totals["arrived"],
        tasks_dispatched=totals["dispatched"],
        tasks_processed=totals["processed"],
        total_emissions=totals["emissions"],
        wall_s=wall_s,
        tasks_per_sec=totals["arrived"] / max(wall_s, 1e-12),
        p50_us=p50, p95_us=p95, p99_us=p99, mean_us=mean,
        max_queue_age=int(queue_age.max()),
        latency_us=lat,
        backlog=backlog,
        queue_age=queue_age,
        emissions=em,
        state=state,
        age_p50=age_p50, age_p95=age_p95, age_p99=age_p99,
    )
    if exporter is not None:
        exporter.close(report)
    return report


def _demo_spec(M: int, N: int, seed: int) -> NetworkSpec:
    rng = np.random.default_rng(seed)
    return NetworkSpec(
        pe=rng.uniform(1, 8, M).astype(np.float32),
        pc=rng.uniform(2, 100, (M, N)).astype(np.float32),
        Pe=1e4,
        Pc=rng.uniform(1e3, 1e5, N).astype(np.float32),
    )


def main(argv=None) -> ServeReport:
    """CLI: `python -m repro_torch.serve`. Serves a synthetic workload on
    the card (or `--device cpu`), prints the latency/throughput summary
    and, with `--outdir`, leaves live-exported Prometheus + JSONL behind.
    REPRO_SMOKE=1 shrinks the instance; even smoke pushes >= 10^4
    synthetic tasks through."""
    from repro_torch.core import CarbonIntensityPolicy, UKRegionalTraceSource, UniformArrivals

    smoke = os.environ.get("REPRO_SMOKE") == "1"
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--slots", type=int, default=24 if smoke else 64)
    ap.add_argument("--types", type=int, default=16 if smoke else 64, help="task types M")
    ap.add_argument("--clouds", type=int, default=4 if smoke else 8)
    ap.add_argument("--amax", type=int, default=100 if smoke else 300)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--flush-every", type=int, default=8)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    report = serve_loop(
        CarbonIntensityPolicy(V=0.05),
        _demo_spec(args.types, args.clouds, args.seed),
        UKRegionalTraceSource(N=args.clouds),
        UniformArrivals(M=args.types, amax=args.amax),
        args.slots,
        args.seed,
        warmup=args.warmup,
        outdir=args.outdir,
        flush_every=args.flush_every,
        device=args.device,
    )
    print(f"served {report.slots} slots (M={args.types}, N={args.clouds}, amax={args.amax}) "
          f"on {args.device}")
    print(f"tasks arrived {report.tasks_arrived:.0f}, processed {report.tasks_processed:.0f}, "
          f"throughput {report.tasks_per_sec:,.0f} tasks/sec")
    print(f"decision latency p50 {report.p50_us:.0f} us, p95 {report.p95_us:.0f} us, "
          f"p99 {report.p99_us:.0f} us (warmup={report.warmup} excluded)")
    print(f"max queue age {report.max_queue_age} slots, "
          f"emissions {report.total_emissions:.3g} gCO2-eq")
    if report.tasks_arrived < 1e4:
        raise SystemExit(f"serving smoke must cover >= 10^4 tasks, got {report.tasks_arrived:.0f}")
    return report


if __name__ == "__main__":
    main()
