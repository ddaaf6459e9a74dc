"""Where the main slot loop's time goes, on the card: ms per slot in turns
and a profile over the whole run, at chip_smoke.py's phase-4
configuration (M4096 x N256, T=64, summary records, the same spec,
backlog and diurnal carbon table).

    python3 src/repro_torch/launch/slot_profile.py [--src DIR] [--label NAME]
        [--turns 4] [--out FILE]

`--src DIR` puts DIR first on the module path before `repro_torch` is
imported, so the script profiles the package of another checkout (its
`src`) as well as this one; run it once per version, in turns, to
compare two versions on one card. It uses only calls that both keys and
int seeds accept (`simulate(policy, spec, carbon, arrivals, T, 0, ...)`).

For each arrival source, `table` (a [T, M] tensor on the card, indexed
a slot), `copy` (that row copied into a new tensor by one kernel) and
`uniform` (the package's `UniformArrivals(M, 400)`), and each
policy (CarbonIntensity V=0.05, QueueLength) it measures:
  - ms per slot from CUDA events and from the host's clock, `--turns`
    rounds of A, B, B, A;
  - one run under torch.profiler over all T slots (its set-up included):
    device busy ms per slot, aten op calls per slot, host self ms per
    slot, and every op's self ms and calls per slot (in `--out`);
  - the arrival source's host time per call alone (256 calls, no sync).
It prints one JSON line per (arrivals, policy) and the nvidia-smi name
and power limit; `--out` gets everything.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

M, N, T, A_MAX, V, SEED = 4096, 256, 64, 400, 0.05, 0


def _instance(torch, convert, carbon, dev):
    """chip_smoke.py's main_instance: the spec of the repo's M4096xN256
    bench rows with budgets at the paper's loads, backlog Qe, Qc ~
    U{0..999}, a diurnal carbon table, and the numpy arrival table the
    main path drew from before it drew JAX's stream."""
    rng = np.random.default_rng(SEED)
    pe = rng.uniform(1, 8, M).astype(np.float32)
    pc = rng.uniform(2, 100, (M, N)).astype(np.float32)
    mean_arrivals = M * A_MAX / 2
    Pe = np.float32(pe.mean() * mean_arrivals / 0.86)
    Pc = np.full(N, pc.mean() * mean_arrivals / N / 0.33, np.float32)
    Qe0 = rng.integers(0, 1000, M).astype(np.float32)
    Qc0 = rng.integers(0, 1000, (M, N)).astype(np.float32)
    table = carbon.diurnal_table(T, N, rng)
    arrivals = rng.integers(0, A_MAX + 1, (T, M)).astype(np.float32)
    return (convert.spec_from_numpy(pe, pc, Pe, Pc, dev), convert.state_from_numpy(Qe0, Qc0, dev),
            carbon.TableCarbonSource(table=table).to(dev),
            torch.as_tensor(arrivals, device=dev))


class _TableArrivals:
    """Row t of a [T, M] tensor already on the card: no draw, no copy
    (with `copy`, the row copied into a new tensor: one kernel a slot)."""

    def __init__(self, table, copy=False):
        self.table, self.copy = table, copy

    def __call__(self, t, key, device):
        row = self.table[t % self.table.shape[0]]
        return row.clone() if self.copy else row


def _profile(torch, run):
    """(device busy ms, {op: (self host ms, calls)}) of `run()`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy, host = 0.0, {}
    for evt in prof.key_averages():
        if evt.key.startswith("repro."):
            continue  # phase labels: spans over the kernels inside them
        if evt.device_type == DeviceType.CUDA:
            busy += evt.self_device_time_total / 1e3
        elif evt.device_type == DeviceType.CPU:
            host[evt.key] = (evt.self_cpu_time_total / 1e3, evt.count)
    return busy, host


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None, help="a checkout's src directory to profile")
    ap.add_argument("--label", default="this")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("slot_profile: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import convert
    from repro_torch import core
    from repro_torch.core import carbon, simulator

    dev = torch.device("cuda")
    spec, state0, carbon_src, arr_table = _instance(torch, convert, carbon, dev)
    sources = {"table": _TableArrivals(arr_table), "copy": _TableArrivals(arr_table, copy=True),
               "uniform": core.UniformArrivals(M=M, amax=A_MAX)}
    policies = {"CarbonIntensity": core.CarbonIntensityPolicy(V=V),
                "QueueLength": core.QueueLengthPolicy()}

    def sim(pol, arr, slots):
        return core.simulate(pol, spec, carbon_src, arr, slots, SEED, state0=state0,
                             record="summary", device=dev)

    out = {"label": args.label, "package": repro_torch.__file__, "torch": torch.__version__,
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.strip(),
           "runs": {}}
    for aname, arr in sources.items():
        for pol in policies.values():
            sim(pol, arr, 4)  # builds the kernels, stages the sources
        torch.cuda.synchronize()
        names = list(policies)
        dev_ms = {p: [] for p in names}
        host_ms = {p: [] for p in names}
        for _ in range(args.turns):
            for pname in names + names[::-1]:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                start.record()
                sim(policies[pname], arr, T)
                end.record()
                end.synchronize()
                host_ms[pname].append(1e3 * (time.perf_counter() - h0) / T)
                dev_ms[pname].append(start.elapsed_time(end) / T)
        # the arrival source alone: host time per call, as a slot calls it
        loop = simulator.make_slot_loop(policies[names[0]], spec, carbon_src, arr, SEED, dev)
        k_arrive = loop[4][1]  # the second of the run's three seeds or keys
        for t in range(8):
            loop.arrival_source(t, k_arrive, dev)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for t in range(256):
            loop.arrival_source(t % T, k_arrive, dev)
        arr_us = 1e6 * (time.perf_counter() - h0) / 256
        torch.cuda.synchronize()
        for pname, pol in policies.items():
            busy, host = _profile(torch, lambda pol=pol: sim(pol, arr, T))
            per_slot = {k: (v[0] / T, v[1] / T) for k, v in host.items()}
            rec = {
                "ms_per_slot": dev_ms[pname], "host_ms_per_slot": host_ms[pname],
                "median_ms": statistics.median(dev_ms[pname]),
                "profile_busy_ms_per_slot": busy / T,
                "profile_aten_calls_per_slot": sum(c for k, (_, c) in per_slot.items()
                                                   if k.startswith("aten::")),
                "profile_host_self_ms_per_slot": sum(v for v, _ in per_slot.values()),
                "arrivals_host_us_per_call": arr_us,
                "top_host_ops": sorted(((round(v, 5), round(c, 2), k)
                                        for k, (v, c) in per_slot.items()), reverse=True)[:8],
            }
            out["runs"][f"{aname} {pname}"] = dict(rec, ops=per_slot)
            print(json.dumps({"label": args.label, "run": f"{aname} {pname}",
                              **{k: v for k, v in rec.items()}}), flush=True)
    print(out["smi"], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
