"""Serving loop: slots decided one at a time as they land (counterpart
of `repro.serve.loop`).

`make_serve_step` returns the one serving step, which runs the same
per-slot body as `core.simulator.simulate` (`slot_step`, the same
`split(key, 3)`), so driving it over t = 0..T-1 reproduces the batch trajectory
bitwise, with the deadline layer too (`deadlines=`: the carried state is
then the pair (NetworkState, DeadlineState)). `serve_loop` drives it
from the host and times every decision:
the wall time of one step, with `torch.cuda.synchronize()` before the
clock is read again, so a latency covers the device work and not only
its enqueueing. Percentiles (p50/p95/p99, `np.percentile` linear
interpolation) exclude the first `warmup` slots, which pay the kernel
build and first launches.

The clock is injectable (`clock=`) and is called once before the loop,
twice per slot and once after, so tests get deterministic histograms.
Every `flush_every` slots the JSONL event log grows one `slot` event per
slot and the Prometheus snapshot is rewritten; `close` appends the
terminal `summary` event, computed from the same per-slot values. A
deadline-aware run adds each slot's missed and shed counts to the events,
the totals and the report, and reads the queue-age percentiles against
the tightest configured deadline.
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
from repro_torch.telemetry.profile import phase

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
    # deadline-aware serving (0.0 when `deadlines` is off):
    missed_total: float = 0.0  # tasks expired past their deadline
    shed_total: float = 0.0    # arrivals rejected by admission control
    age_p50: float = 0.0       # queue-age percentiles over all slots, read
    age_p95: float = 0.0       #   against the configured deadline
    age_p99: float = 0.0
    age_over_deadline_frac: float = 0.0  # slots with age > the least deadline
    dstate: object = None      # the deadline carry after the last slot, or None


def latency_percentiles(lat_us) -> tuple:
    """(p50, p95, p99, mean) of a latency sample, `np.percentile` linear
    interpolation."""
    lat = np.asarray(lat_us, np.float64)
    p50, p95, p99 = (float(x) for x in np.percentile(lat, [50.0, 95.0, 99.0]))
    return p50, p95, p99, float(lat.mean())


def make_serve_step(policy, spec: NetworkSpec, carbon_source, arrival_source,
                    key=0, device=DEFAULT_DEVICE, deadlines=None):
    """The serving step `(state, t) -> (state', metrics)`, metrics a [5]
    float32 tensor on the device: (emissions, arrived, dispatched,
    processed, backlog). One tensor, so the host reads a slot's metrics
    with one copy.

    With `deadlines` (a DeadlineParams) the carried state is the pair
    (NetworkState, DeadlineState), the policy gets the slot's
    `deadline_view=` and metrics grows (missed, shed): the batch
    simulator's deadline slot, so the served trajectory is bitwise the
    batch one."""
    loop = make_slot_loop(policy, spec, carbon_source, arrival_source, key, device, deadlines)

    def step(state, t: int):
        dstate = None
        if deadlines is not None:
            state, dstate = state
        with phase("slot"):
            s = slot_step(loop, state, t, dstate=dstate)
        nxt, act = s.state, s.act
        metrics = [
            s.C,
            torch.sum(s.a),
            torch.sum(act.d),
            torch.sum(act.w),
            torch.sum(nxt.Qe) + torch.sum(nxt.Qc),
        ]
        if deadlines is None:
            return nxt, torch.stack(metrics)
        return (nxt, s.dstate), torch.stack(metrics + [torch.sum(s.expired), torch.sum(s.shed)])

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
        self._totals = {"arrived": 0.0, "dispatched": 0.0, "processed": 0.0, "emissions": 0.0,
                        "missed": 0.0, "shed": 0.0}
        self._last = {"backlog": 0.0, "queue_age": 0}

    def record(self, t: int, latency_us: float, arrived: float, dispatched: float,
               processed: float, backlog: float, queue_age: int, emissions_t: float,
               missed: float = 0.0, shed: float = 0.0) -> None:
        self._pending.append(json.dumps({
            "event": "slot", "kind": "serve", "t": t,
            "latency_us": latency_us, "arrived": arrived,
            "dispatched": dispatched, "processed": processed,
            "backlog": backlog, "queue_age": queue_age,
            "emissions": emissions_t, "warmup": t < self.warmup,
            "missed": missed, "shed": shed,
        }))
        self._slots += 1
        if t >= self.warmup:
            self._lat.append(latency_us)
        self._totals["arrived"] += arrived
        self._totals["dispatched"] += dispatched
        self._totals["processed"] += processed
        self._totals["emissions"] += emissions_t
        self._totals["missed"] += missed
        self._totals["shed"] += shed
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
            help_ = {
                "missed": "tasks expired past their deadline (tasks)",
                "shed": "arrivals rejected by admission control (tasks)",
            }.get(k, f"running {k} over served slots ({unit})")
            emit(f"repro_serve_{k}_total", "counter", help_, [("", v)])
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
            "missed_total": report.missed_total,
            "shed_total": report.shed_total,
            "age_p50": report.age_p50, "age_p95": report.age_p95,
            "age_p99": report.age_p99,
            "age_over_deadline_frac": report.age_over_deadline_frac,
        }
        with self.paths["jsonl"].open("a") as fh:
            fh.write(json.dumps(summary) + "\n")
        self.paths["prometheus"].write_text(self._prometheus())
        return self.paths


def serve_loop(policy, spec: NetworkSpec, carbon_source, arrival_source, T: int,
               key=0, *, warmup: int = 2, clock=None, outdir=None,
               stem: str = "serve", flush_every: int = 16,
               device=DEFAULT_DEVICE, deadlines=None) -> ServeReport:
    """Drives `make_serve_step` for T slots from the host, timing every
    decision. `key` is an int seed (`PRNGKey(seed)`) or a threefry key.
    `clock` defaults to `time.perf_counter` (called 2T + 2 times).
    `outdir` turns on live export via ServeExporter. Percentiles cover
    slots[warmup:]; `warmup` is clamped to T-1.

    `deadlines` (a DeadlineParams) serves deadline-aware: each slot's
    expiries and sheds go into the report and the live export, shed
    arrivals never enter the queue-age FIFO and expired tasks leave it,
    and the queue-age percentiles are read against the tightest finite
    deadline (`age_over_deadline_frac`)."""
    if clock is None:
        clock = time.perf_counter
    warmup = max(0, min(warmup, T - 1))
    exporter = None
    if outdir is not None:
        exporter = ServeExporter(outdir, stem=stem, flush_every=flush_every, warmup=warmup)
    dev = resolve_device(device)
    step = make_serve_step(policy, spec, carbon_source, arrival_source, key, dev, deadlines)
    state = init_state(spec.M, spec.N, device=dev)
    if deadlines is not None:
        from repro_torch.deadlines.model import init_deadlines

        state = (state, init_deadlines(spec.M, deadlines.D, dev))
    ages = _AgeFifo()
    lat = np.zeros(T)
    backlog = np.zeros(T)
    em = np.zeros(T, np.float32)
    queue_age = np.zeros(T, np.int64)
    totals = {"arrived": 0.0, "dispatched": 0.0, "processed": 0.0, "emissions": 0.0,
              "missed": 0.0, "shed": 0.0}

    t_start = clock()
    for t in range(T):
        c0 = clock()
        state, metrics = step(state, t)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        c1 = clock()
        lat[t] = (c1 - c0) * 1e6
        missed_t = shed_t = 0.0
        if deadlines is None:
            em_t, arrived, dispatched, processed, bl = metrics.tolist()
        else:
            em_t, arrived, dispatched, processed, bl, missed_t, shed_t = metrics.tolist()
        totals["arrived"] += arrived
        totals["dispatched"] += dispatched
        totals["processed"] += processed
        totals["emissions"] += em_t
        totals["missed"] += missed_t
        totals["shed"] += shed_t
        backlog[t] = bl
        em[t] = em_t
        # shed arrivals never enter the queue and missed tasks leave it by
        # expiry: both go through the age FIFO (no-ops without deadlines)
        queue_age[t] = ages.update(t, arrived - shed_t, processed + missed_t)
        if exporter is not None:
            exporter.record(t, lat[t], arrived, dispatched, processed, bl,
                            int(queue_age[t]), em_t, missed=missed_t, shed=shed_t)
    wall_s = clock() - t_start

    p50, p95, p99, mean = latency_percentiles(lat[warmup:])
    age_p50, age_p95, age_p99 = (float(x) for x in np.percentile(queue_age, [50.0, 95.0, 99.0]))
    over_frac = 0.0
    dstate = None
    if deadlines is not None:
        state, dstate = state
        d = deadlines.deadline
        d = d.detach().cpu().numpy() if torch.is_tensor(d) else np.asarray(d)
        finite = np.asarray(d, np.float64)[np.isfinite(d)]
        if finite.size:
            over_frac = float(np.mean(queue_age > finite.min()))
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
        missed_total=totals["missed"],
        shed_total=totals["shed"],
        age_p50=age_p50, age_p95=age_p95, age_p99=age_p99,
        age_over_deadline_frac=over_frac,
        dstate=dstate,
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
    ap.add_argument("--deadline", type=float, default=None,
                    help="serve deadline-aware: max extra waiting slots per task before it "
                         "expires (default: off)")
    ap.add_argument("--shed", action="store_true",
                    help="with --deadline: admission control sheds arrivals projected capacity "
                         "cannot clear")
    ap.add_argument("--headroom", type=float, default=0.9,
                    help="admission capacity factor for --shed")
    args = ap.parse_args(argv)

    deadlines = None
    policy = CarbonIntensityPolicy(V=0.05)
    if args.deadline is not None:
        from repro_torch.deadlines import SlackThresholdPolicy, make_deadlines

        deadlines = make_deadlines(args.types, device=args.device, deadline=args.deadline,
                                   shed_on=1.0 if args.shed else 0.0, headroom=args.headroom)
        policy = SlackThresholdPolicy(V=0.05)

    report = serve_loop(
        policy,
        _demo_spec(args.types, args.clouds, args.seed),
        UKRegionalTraceSource(N=args.clouds),
        UniformArrivals(M=args.types, amax=args.amax),
        args.slots,
        args.seed,
        warmup=args.warmup,
        outdir=args.outdir,
        flush_every=args.flush_every,
        device=args.device,
        deadlines=deadlines,
    )
    print(f"served {report.slots} slots (M={args.types}, N={args.clouds}, amax={args.amax}) "
          f"on {args.device}")
    print(f"tasks arrived {report.tasks_arrived:.0f}, processed {report.tasks_processed:.0f}, "
          f"throughput {report.tasks_per_sec:,.0f} tasks/sec")
    print(f"decision latency p50 {report.p50_us:.0f} us, p95 {report.p95_us:.0f} us, "
          f"p99 {report.p99_us:.0f} us (warmup={report.warmup} excluded)")
    print(f"max queue age {report.max_queue_age} slots, "
          f"emissions {report.total_emissions:.3g} gCO2-eq")
    if deadlines is not None:
        print(f"queue age p50/p95/p99 {report.age_p50:.0f}/{report.age_p95:.0f}/"
              f"{report.age_p99:.0f} slots vs deadline {args.deadline:g} (over-deadline "
              f"{report.age_over_deadline_frac:.1%}); missed {report.missed_total:.0f}, "
              f"shed {report.shed_total:.0f}")
    if report.tasks_arrived < 1e4:
        raise SystemExit(f"serving smoke must cover >= 10^4 tasks, got {report.tasks_arrived:.0f}")
    return report


if __name__ == "__main__":
    main()
