"""Streaming taps: live TapSeries flushes out of running loops
(counterpart of `repro.telemetry.stream`).

Passing ``telemetry=StreamConfig(flush_every=k)`` to any simulator runs
the same taps as a ``TelemetryConfig`` run, and after every k slots
runs the tap kernel over those k slots from the carried tap state
(`kernels.ops.tap_scan`, one launch a chunk), copies the chunk's
[*lanes, k] TapSeries slice to the host in one copy, and pushes it to a
host-side ``StreamChannel``, one push a lane tagged (lane, t0).
Consumers subscribe to the channel (`export.follow_run` feeds the
Prometheus / JSONL exporters from it), and ``StreamChannel.series``
reassembles the full [T, ...] TapSeries, bitwise the batch frame's.

Contract:

* values never change: the chunks run the batch run's kernel over the
  same series in the same order, and the last chunk computes the run's
  gauges and alert records over all T slots, so the streamed frame is
  bitwise the batch frame, every field;
* the flush is unconditional, once a chunk, and runs on the calling
  thread between slots (it waits for the chunk's values, so a streamed
  run syncs with the card once a chunk). The channel keeps its lock, so
  a consumer may read it from another thread.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.telemetry.profile import phase
from repro_torch.telemetry.taps import TapSeries, TelemetryConfig


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Opt-in streaming telemetry. Frozen and hashable, as
    TelemetryConfig.

    taps         the TelemetryConfig the taps run with (the streamed
                 values are its TapSeries, untouched)
    flush_every  slots a flush; must divide T
    channel      name of the host StreamChannel flushes land on
    capacity     max buffered slices the channel retains (ring buffer;
                 oldest dropped first). Subscribers see every flush
                 regardless -- capacity only bounds replay memory.
    """

    taps: TelemetryConfig = TelemetryConfig()
    flush_every: int = 16
    channel: str = "default"
    capacity: int = 4096

    def __post_init__(self):
        if self.flush_every < 1:
            raise ValueError(f"flush_every={self.flush_every} must be >= 1")


def split_telemetry(telemetry):
    """Normalizes a simulator's `telemetry` argument into
    (TelemetryConfig | None, StreamConfig | None): plain configs run
    batch-only, StreamConfig runs its `.taps` config plus flushes."""
    if telemetry is None:
        return None, None
    if isinstance(telemetry, StreamConfig):
        return telemetry.taps, telemetry
    return telemetry, None


def check_stream(stream: StreamConfig, T: int, record) -> None:
    """The JAX package's refusals: flush_every divides T, and the record
    mode is "full", "summary" or the stride flush_every itself."""
    k = stream.flush_every
    if T % k != 0:
        raise ValueError(f"streaming needs flush_every={k} to divide T={T}")
    if record not in ("full", "summary") and (not isinstance(record, int) or record != k):
        raise ValueError(
            f"streaming runs chunk the scan at flush_every={k}; record must be 'full', "
            f"'summary', or the stride {k} itself (got record={record!r})")


class StreamChannel:
    """Host-side landing zone for one stream of flushed slices.

    Slices are kept (up to `capacity`, oldest dropped) for replay via
    `series`; subscribers are called on every push. All state is under
    one lock, so readers on other threads see whole pushes."""

    def __init__(self, name: str, capacity: int = 4096):
        self.name = name
        self.capacity = capacity
        self._lock = threading.Lock()
        self._slices: List[Tuple[int, int, TapSeries]] = []
        self._subscribers: List[Callable] = []
        self.flushes = 0
        self.dropped = 0

    def subscribe(self, fn: Callable) -> Callable:
        """Registers fn(lane, t0, slice_) on every flush; returns fn."""
        with self._lock:
            self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    def push(self, lane: int, t0: int, slice_: TapSeries) -> None:
        with self._lock:
            self.flushes += 1
            self._slices.append((lane, t0, slice_))
            while len(self._slices) > self.capacity:
                self._slices.pop(0)
                self.dropped += 1
            subs = list(self._subscribers)
        for fn in subs:
            fn(lane, t0, slice_)

    def clear(self) -> None:
        with self._lock:
            self._slices.clear()
            self.flushes = 0
            self.dropped = 0

    def lanes(self) -> List[int]:
        with self._lock:
            return sorted({lane for lane, _, _ in self._slices})

    def series(self, lane: int = 0) -> TapSeries:
        """Reassembles the buffered slices of one lane into the full
        [T, ...] TapSeries (numpy), ordered by start slot -- bitwise the
        batch frame's series when no slice was dropped."""
        with self._lock:
            got = sorted(((t0, s) for ln, t0, s in self._slices if ln == lane),
                         key=lambda x: x[0])
        if not got:
            raise ValueError(f"channel {self.name!r} holds no slices for lane {lane} "
                             f"(lanes seen: {self.lanes()})")
        return TapSeries(*(np.concatenate([np.asarray(getattr(s, f)) for _, s in got])
                           for f in TapSeries._fields))


_CHANNELS: Dict[str, StreamChannel] = {}
_CHANNELS_LOCK = threading.Lock()


def channel(name: str = "default", capacity: int = 4096) -> StreamChannel:
    """Returns (creating on first use) the named StreamChannel."""
    with _CHANNELS_LOCK:
        ch = _CHANNELS.get(name)
        if ch is None:
            ch = _CHANNELS[name] = StreamChannel(name, capacity)
        return ch


def reset_channel(name: str = "default") -> StreamChannel:
    """Clears the named channel's buffer and counters (subscribers
    stay); the idiom at the top of every streaming run."""
    ch = channel(name)
    ch.clear()
    return ch


def host_slices(series: TapSeries, t0: int, t1: int) -> List[TapSeries]:
    """Slots t0..t1-1 of a run's [*lanes, T, ...] TapSeries, on the host
    in one copy (the int32 fields ride as float32 bits), one numpy
    TapSeries a lane ([k, ...] fields; a run without lanes is lane 0)."""
    lanes = tuple(series.backlog.shape[:-1])
    k = t1 - t0
    parts, widths = [], []
    for x in series:
        part = (x[..., t0:t1] if x.dim() == len(lanes) + 1 else x[..., t0:t1, :]).reshape(
            lanes + (k, -1))
        parts.append(part.view(torch.float32) if part.dtype == torch.int32 else part)
        widths.append(part.shape[-1])
    host = torch.cat(parts, dim=-1).cpu().numpy().reshape(-1, k, sum(widths))
    out = []
    for row in host:
        cols, at = [], 0
        for x, w in zip(series, widths):
            col = row[:, at:at + w]
            col = col.view(np.int32) if x.dtype == torch.int32 else col
            cols.append(col if x.dim() > len(lanes) + 1 else col[:, 0])
            at += w
        out.append(TapSeries(*(np.ascontiguousarray(c) for c in cols)))
    return out


def stream_flush(cfg: StreamConfig, series: TapSeries, t0: int, t1: int) -> None:
    """Hands slots t0..t1-1 of the run's TapSeries to the host channel,
    one push a lane tagged (lane, t0): the one copy to the host a run
    makes inside its slots, labelled `repro.stream_flush`."""
    ch = channel(cfg.channel, cfg.capacity)
    with phase("stream_flush"):
        for lane, slice_ in enumerate(host_slices(series, t0, t1)):
            ch.push(lane, t0, slice_)


__all__ = [
    "StreamConfig",
    "StreamChannel",
    "channel",
    "reset_channel",
    "split_telemetry",
    "stream_flush",
]
