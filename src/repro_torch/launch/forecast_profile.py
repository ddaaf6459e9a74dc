"""RidgeAR's cost on the card once its window is full: ms per slot of
LookaheadDPP(H=8) fed `RidgeARForecaster(H=8)` (lags 8, window 64), and
one predict alone.

    python3 src/repro_torch/launch/forecast_profile.py [--src DIR] [--label NAME]
        [--turns 2]

`--src DIR` puts DIR first on the module path before `repro_torch` is
imported, so the script times the package of another checkout (its
`src`) as well as this one; run it once per version, in turns, to
compare two versions on one card.

It measures, with CUDA events:
  - the forecast rows' fleet (`build_fleet(["diurnal"], per_kind=16,
    Tc=96, seed=0)`, F16 x M5 x N5, V=0.2, summary records) at T=64
    (the window fills at the last slot: one refit) and T=192 (129
    refits); the warm slots' ms is the difference of the two runs over
    the 128 slots between them, each slot a refit and a 7-step rollout;
  - one predict with a full window over fleet B's carbon tables (F16 x
    257 regions: `build_fleet` of four kinds x 4 at M4096 x N256).
Each in `--turns` rounds. It prints one JSON line and the nvidia-smi
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

V, H, SEED, T_SHORT, T_LONG = 0.2, 8, 0, 64, 192
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
        print("forecast_profile: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import core
    from repro_torch import forecast as fcst
    from repro_torch.configs import fleet_scenarios

    dev = torch.device("cuda")
    fl = fleet_scenarios.build_fleet(["diurnal"], per_kind=16, Tc=96, seed=SEED,
                                     device=dev).to(dev)
    la = core.LookaheadDPPPolicy(V=V, H=H, discount=0.98, defer_weight=2.0)
    ridge = fcst.RidgeARForecaster(H=H)

    def run_ms(T):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = core.simulate_fleet(la, fl, T, SEED, record="summary", device=dev,
                                  forecaster=ridge)
        end.record()
        end.synchronize()
        if not bool(torch.isfinite(res.cum_emissions).all()):
            raise SystemExit("forecast_profile: non-finite emissions")
        return start.elapsed_time(end)

    carbon_b = fleet_scenarios.build_fleet(FLEET_B_KINDS, per_kind=4, M=4096, N=256, Tc=96,
                                           seed=SEED, device=dev).to(dev).carbon
    carry = ridge.init(carbon_b.shape[-1] - 1, device=dev)
    for t in range(ridge.window):
        carry = ridge.update(carry, carbon_b[:, t % carbon_b.shape[1]])

    def predict_ms():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ridge.predict(carry, ridge.window - 1)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    run_ms(T_SHORT)  # builds the kernels, stages the fleet
    predict_ms()
    short, long, warm, pred = [], [], [], []
    for _ in range(args.turns):
        a, b = run_ms(T_SHORT), run_ms(T_LONG)
        short.append(a / T_SHORT)
        long.append(b / T_LONG)
        warm.append((b - a) / (T_LONG - T_SHORT))
        pred.append(statistics.median(predict_ms() for _ in range(5)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "package": repro_torch.__file__,
                      "torch": torch.__version__,
                      "fleet": f"diurnal F{fl.F} x M5 x N5, LookaheadDPP(H={H}) + RidgeAR",
                      f"ms_per_slot_T{T_SHORT}": short, f"ms_per_slot_T{T_LONG}": long,
                      "warm_ms_per_slot": warm,
                      "predict_ms_F16x257": pred}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
