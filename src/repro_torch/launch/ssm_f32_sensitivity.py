"""How far mamba2-1.3B's float32 prefill logits move when the SSD
intra-chunk step changes in its last bits.

  python -m repro_torch.launch.ssm_f32_sensitivity [--batch 8] [--prompt 4096]

Builds the model as chip_smoke.py phase 9 does (the port's seeded init,
bf16 weights, float32 activations, prompts from seed 0) and runs one
prefill with the step from each source: the plain version (the
reference), the CUDA kernel, the plain version with its y_diag and S_c
changed by a relative 1e-7 or 1e-6 (random, seeded), the plain version
scaled by 1 - 1e-6, and a float64 evaluation rounded to float32. For
each it prints the relative L2 distance of the logits from the plain
path's and from the float64 path's. Runs on the CUDA card only.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as sdc
from repro_torch.models import build_model


def _changed(scale_fn):
    """The plain step with y_diag and S_c multiplied by scale_fn(shape)."""
    def run(a, x, Bm, Cm):
        y, S_c, total = sdc.ssd_chunk_intra_plain(a, x, Bm, Cm)
        return y * scale_fn(y.shape), S_c * scale_fn(S_c.shape), total
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = registry.get_config("mamba2_1_3b")
    params = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(args.seed))
    model = build_model(dataclasses.replace(cfg, compute_dtype="float32"), dev)
    prompts = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt)).astype(np.int32), device=dev)
    noise = torch.Generator(device=dev).manual_seed(args.seed)

    def jitter(eps):
        return lambda shape: 1.0 + eps * torch.randn(shape, generator=noise, device=dev)

    steps = {
        "plain": sdc.ssd_chunk_intra_plain,
        "kernel": sdc.ssd_chunk_intra_cuda,
        "plain x (1 + 1e-7 N(0,1))": _changed(jitter(1e-7)),
        "plain x (1 + 1e-6 N(0,1))": _changed(jitter(1e-6)),
        "plain x (1 - 1e-6)": _changed(lambda shape: 1.0 - 1e-6),
        "float64": lambda *t: tuple(v.float() for v in sdc.ssd_chunk_intra_f64(*t)),
    }
    logits = {}
    saved = ops.ssd_chunk_intra
    try:
        for name, fn in steps.items():
            ops.ssd_chunk_intra = fn
            with torch.no_grad():
                logits[name], _ = model.prefill(params, {"tokens": prompts},
                                                cache_len=args.prompt + 1)
    finally:
        ops.ssd_chunk_intra = saved

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    print(f"mamba2-1.3b float32 prefill logits, batch {args.batch}, prompts of {args.prompt} "
          f"tokens, seed {args.seed} ({torch.cuda.get_device_name(dev)})")
    for name, lg in logits.items():
        print(f"  SSD step {name}: relative L2 from the plain path {rel(lg, logits['plain']):.3e}, "
              f"from the float64 path {rel(lg, logits['float64']):.3e}; finite "
              f"{bool(torch.isfinite(lg).all())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
