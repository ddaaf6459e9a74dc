"""Helpers the launch scripts' kernel profiles share: device times from
CUDA-graph replay, torch.profiler's device time by kernel, ptxas's
register and spill lines, and an edited copy of a kernel source built
beside the package's. Each takes `torch` and the package's `build` module
from its caller and imports nothing of the package, so a script that
times another checkout's package (`attention_profile.py --src`) loads
this file from beside itself.
"""
from __future__ import annotations

import re
import statistics


def replay_ms(torch, fn, reps: int, inner: int) -> float:
    """Device ms a call: `inner` calls captured in one CUDA graph, the
    median of `reps` replays between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / inner)
    return statistics.median(ms)


def times(torch, fn, reps: int, inner: int) -> dict:
    """{"ms": cold, "warm_ms": warm}, as chip_smoke.py's graph_ms."""
    flush = torch.empty(32 * 2**20, device="cuda")
    sink = torch.empty((), device="cuda")

    def evict():
        torch.sum(flush, dim=0, out=sink)

    def cold():
        evict()
        fn()

    warm = replay_ms(torch, fn, reps, inner)
    cold_ms = replay_ms(torch, cold, reps, inner) - replay_ms(torch, evict, reps, inner)
    return {"ms": cold_ms, "warm_ms": warm}


def ptxas(log: str, entry: str, tags=("<128>", "<256>")) -> list:
    """ptxas -v's register and spill lines for the entries whose name holds
    `entry`, of the template instances in `tags` (None: every one)."""
    out, keep, tag = [], False, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = entry in ln
            tag = "<" + ",".join(re.findall(r"ILi(\d+)E", ln)) + ">"
        elif keep and (tags is None or tag in tags) and ("registers" in ln or "spill" in ln):
            out.append(f"{entry}{tag} " + ln.split(":", 1)[-1].strip())
    return out


def kernel_ms(torch, fn, calls: int = 5) -> dict:
    """Device ms a launch by kernel name (the first 40 characters): the
    mean over the launches torch.profiler recorded in `calls` calls of
    `fn` (a later profiler session in one process can miss launches, so
    no total is divided by `calls`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            key = evt.key[:40]
            total[key] = total.get(key, 0.0) + evt.self_device_time_total / 1e3
            count[key] = count.get(key, 0) + evt.count
    return {key: total[key] / count[key] for key in total}


def use_edited(build, name: str, text: str, tag: str) -> str:
    """Builds `text` as csrc/<name>.cu through build.py (the library keyed
    by its source's hash, beside the package's) and makes the wrappers
    launch it until `use_package`; returns ptxas's report."""
    edited = build.build_dir().parent / "edited" / tag
    edited.mkdir(parents=True, exist_ok=True)
    (edited / f"{name}.cu").write_text(text)
    for header in build.CSRC.glob("*.cuh"):  # the headers it may include
        (edited / header.name).write_text(header.read_text())
    csrc, build.CSRC = build.CSRC, edited
    try:
        build._LIBS.pop(name, None)
        log = build.build_all((name,))[name][1]
        build.load(name)
    finally:
        build.CSRC = csrc
    return log


def use_package(build, name: str) -> None:
    build._LIBS.pop(name, None)
    build.load(name)
