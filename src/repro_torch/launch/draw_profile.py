"""What the random draws cost the runs that make them, on the card: ms
per slot of the runs whose draws `threefry_draw` serves, in turns.

    python3 src/repro_torch/launch/draw_profile.py [--src DIR] [--label NAME]
        [--turns 2]

`--src DIR` puts DIR first on the module path before `repro_torch` is
imported, so the script times the package of another checkout (its
`src`) as well as this one; run it once per version, in turns, to
compare two versions on one card. It uses only calls that both versions
accept.

Each run, in `--turns` rounds of A, B, ..., B, A, ms per slot from CUDA
events (summary records, seed 0):
  - main: `simulate` with CarbonIntensity (V=0.05) at chip_smoke.py's
    phase-4 configuration (M4096 x N256, T=64: the spec, backlog and
    diurnal table of `slot_profile.py`), arrivals `UniformArrivals(4096,
    400)`: JAX's stream, drawn a slot or a block at a time;
  - fleet B: `simulate_fleet` with CarbonIntensity on chip_smoke's fleet
    B (four kinds x 4 lanes at M4096 x N256, T=64): the fleet's arrivals;
  - noisy / exact: the JAX bench's forecast rows la_H8_noisy20 and
    la_H8_perfect (LookaheadDPP(H=8) on `build_fleet(["diurnal"], 16)`,
    F16 x M5 x N5, V=0.2, T=192): the error model's normal draw a slot;
  - UK table: `UKRegionalTraceSource(N=5).table(2000)`, ms for the table
    (the trace's noise, a normal draw over every block of slots).
It prints one JSON line and the nvidia-smi name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

SEED, T_MAIN, T_FC, V_FC = 0, 64, 192, 0.2
FLEET_B_KINDS = ("diurnal", "bursty", "heterogeneous-fleet", "overload")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None, help="a checkout's src directory to time")
    ap.add_argument("--label", default="this")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("draw_profile: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import convert, core
    from repro_torch import forecast as fcst
    from repro_torch.configs import fleet_scenarios
    from repro_torch.core import carbon
    from repro_torch.launch import slot_profile

    dev = torch.device("cuda")
    spec, state0, table, _ = slot_profile._instance(torch, convert, carbon, dev)
    arrivals = core.UniformArrivals(M=slot_profile.M, amax=slot_profile.A_MAX)
    ci = core.CarbonIntensityPolicy(V=slot_profile.V)
    fleet_b = fleet_scenarios.build_fleet(FLEET_B_KINDS, per_kind=4, M=4096, N=256, Tc=96,
                                          seed=SEED, device=dev).to(dev)
    fleet_fc = fleet_scenarios.build_fleet(["diurnal"], per_kind=16, Tc=96, seed=SEED,
                                           device=dev).to(dev)
    la8 = core.LookaheadDPPPolicy(V=V_FC, H=8, discount=0.98, defer_weight=2.0)
    la8_perfect = core.LookaheadDPPPolicy(V=V_FC, H=8, discount=1.0, defer_weight=3.0)
    noisy = fcst.ClairvoyantTableForecaster(H=8, error=fcst.ForecastErrorModel(noise=0.2, seed=7))
    exact = fcst.ClairvoyantTableForecaster(H=8)
    runs = {
        "main": (lambda: core.simulate(ci, spec, table, arrivals, T_MAIN, SEED, state0=state0,
                                       record="summary", device=dev), T_MAIN),
        "fleet B": (lambda: core.simulate_fleet(ci, fleet_b, T_MAIN, SEED, record="summary",
                                                device=dev), T_MAIN),
        "noisy": (lambda: core.simulate_fleet(la8, fleet_fc, T_FC, SEED, record="summary",
                                              device=dev, forecaster=noisy), T_FC),
        "exact": (lambda: core.simulate_fleet(la8_perfect, fleet_fc, T_FC, SEED,
                                              record="summary", device=dev, forecaster=exact),
                  T_FC),
        "UK table": (lambda: core.UKRegionalTraceSource(N=5).table(2000, device=dev), 1),
    }

    def ms(fn, slots):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / slots

    for fn, slots in runs.values():  # builds the kernels, stages the sources
        ms(fn, slots)
    names = list(runs)
    times = {n: [] for n in names}
    for _ in range(args.turns):
        for name in names + names[::-1]:
            times[name].append(ms(*runs[name]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "package": repro_torch.__file__,
                      "torch": torch.__version__, "ms_per_slot": times}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
