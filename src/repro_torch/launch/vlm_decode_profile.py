"""PaliGemma-3B's decode steps at full size (chip_smoke.py phase 11's
serving shape), for comparing two versions of the package on one card.

    python3 src/repro_torch/launch/vlm_decode_profile.py [--src DIR] [--label NAME]
        [--rounds 3]

`--src DIR` puts DIR first on the module path before `repro_torch` is
imported (by default this checkout's `src`), so the script times the
package of another checkout (its `src`) as well as this one; run it once
per version, in turns (old, new, new, old), to compare two versions on
one card. It calls only `build_model`, `Model.init`, `Model.prefill` and
`Model.decode_step`, which every version with the vlm family accepts.

As phase 11 does, it builds PaliGemma-3B with the seed's weights (bf16)
and makes its batch from numpy's seed: 8 rows of 256 patch embeddings
and 3,840 tokens. It runs one prefill into a 4,161-slot cache, then
`--rounds` rounds of 64 greedy decode steps from that cache
(`decode_step` and argmax on the device, phase 11's timed loop; every
round writes the same 64 slots), each round timed with CUDA events (ms a
step) and with the host's clock. Then 8 more steps under torch.profiler:
the device's busy ms a step, the idle share (1 - busy / the rounds'
median ms a step), the aten op calls a step, the host's self ms a step
in them, and the device ms a step of the attention kernels. It prints
one JSON line, then the nvidia-smi name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED, ARCH, BATCH, PROMPT, STEPS, PROFILED = 0, "paligemma_3b", 8, 4096, 64, 8


def _profile(torch, run, steps: int) -> dict:
    """Device busy ms, aten op calls, their host self ms and the
    attention kernels' device ms, each a step, of `run()` over `steps`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy, attention, calls, host = 0.0, 0.0, 0, 0.0
    for evt in prof.key_averages():
        if evt.key.startswith("repro."):  # spans over the kernels inside them
            continue
        if evt.device_type == DeviceType.CUDA:
            busy += evt.self_device_time_total / 1e3
            if "attention_tc" in evt.key or "decode_tc" in evt.key:
                attention += evt.self_device_time_total / 1e3
        elif evt.key.startswith("aten::"):
            calls += evt.count
            host += evt.self_cpu_time_total / 1e3
    return {"busy_ms": busy / steps, "attention_ms": attention / steps,
            "aten_calls": calls / steps, "aten_host_ms": host / steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None, help="a checkout's src directory to time")
    ap.add_argument("--label", default="this")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve() if args.src else Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("vlm_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = registry.get_config(ARCH)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    P = cfg.prefix_len
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT - P))
                                       .astype(np.int32), device=dev),
             "patches": torch.as_tensor(rng.standard_normal((BATCH, P, cfg.d_model),
                                                            dtype=np.float32), device=dev)
             .to(getattr(torch, cfg.compute_dtype))}
    logits, cache = model.prefill(params, batch, cache_len=PROMPT + STEPS + 1)
    tok0 = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)

    def steps(n):
        c, tok = dict(cache), tok0
        for _ in range(n):
            out, c = model.decode_step(params, tok, c)
            tok = torch.argmax(out, dim=-1)[:, None].to(torch.int32)
        return tok

    steps(2)  # the kernels built and loaded
    line = {"label": args.label, "package": repro_torch.__file__, "torch": torch.__version__,
            "ms_per_step": [], "host_ms_per_step": []}
    for _ in range(args.rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        steps(STEPS)
        end.record()
        end.synchronize()
        line["host_ms_per_step"].append((time.perf_counter() - t0) * 1e3 / STEPS)
        line["ms_per_step"].append(start.elapsed_time(end) / STEPS)
    prof = _profile(torch, lambda: steps(PROFILED), PROFILED)
    line.update(prof)
    line["idle_share"] = 1.0 - prof["busy_ms"] / statistics.median(line["ms_per_step"])
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
