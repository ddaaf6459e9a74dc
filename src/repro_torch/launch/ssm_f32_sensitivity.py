"""How far mamba2-1.3B's float32 prefill logits, or its float32
training gradients, move when the SSD intra-chunk step or its backward
changes in its last bits.

  python -m repro_torch.launch.ssm_f32_sensitivity [--batch 8] [--prompt 4096]
  python -m repro_torch.launch.ssm_f32_sensitivity --grad [--batch 8] [--prompt 4096] \
      [--layers 12 48] [--tc]

Builds the model as chip_smoke.py phase 9 does (the port's seeded init,
bf16 weights, float32 activations, prompts from seed 0) and runs one
prefill with the step from each source: the plain version (the
reference), the CUDA kernel, the plain version with its y_diag and S_c
changed by a relative 1e-7 or 1e-6 (random, seeded), the plain version
scaled by 1 - 1e-6, and a float64 evaluation rounded to float32. For
each it prints the relative L2 distance of the logits from the plain
path's and from the float64 path's.

With --grad: one training step's loss and every parameter leaf's
gradient (`Model.loss`, float32 parameters and activations, the batch
from the synthetic stream at seed 0) at each depth of --layers (the
first layers of the seeded init), the step's forward always the plain
version and its backward from each source: the plain backward (the
reference), the plain backward with its outputs (da, dx, dB, dC) changed
by a relative 1e-7 or 1e-6 (random, seeded), the float64 backward rounded
to float32, and the two CUDA kernels (forward and backward). For each it
prints every leaf's relative L2 distance from the plain path's gradient
and the largest of them. With --tc the backward's sources are the plain
backward, its tensor-core arithmetic emulated (`ssd_chunk_intra_bwd_tc`:
3xTF32, and one TF32 product) and the kernels.
Runs on the CUDA card only.
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
from repro_torch.pytree import flatten_with_path, tree_map, tree_unflatten


def _changed(scale_fn):
    """The plain step with y_diag and S_c multiplied by scale_fn(shape)."""
    def run(a, x, Bm, Cm):
        y, S_c, total = sdc.ssd_chunk_intra_plain(a, x, Bm, Cm)
        return y * scale_fn(y.shape), S_c * scale_fn(S_c.shape), total
    return run


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def gradients(args, dev) -> None:
    """The --grad mode (see the module note)."""
    from repro_torch.data import make_batch_fn

    cfg = registry.get_config("mamba2_1_3b")
    params = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(args.seed))
    params = tree_map(lambda t: t.float(), params)
    batch = make_batch_fn(cfg, args.prompt, args.batch, seed=args.seed, device=dev)(0)
    noise = torch.Generator(device=dev).manual_seed(args.seed)

    def jittered(eps):
        def bwd(*t):
            return tuple(g * (1.0 + eps * torch.randn(g.shape, generator=noise, device=dev))
                         for g in sdc.ssd_chunk_intra_bwd_plain(*t))
        return bwd

    plain = sdc.ssd_chunk_intra_plain
    steps = {"plain": (plain, sdc.ssd_chunk_intra_bwd_plain)}
    if args.tc:
        steps.update({
            "3xTF32 backward (emulated)": (plain, sdc.ssd_chunk_intra_bwd_tc),
            "1xTF32 backward (emulated)": (plain, lambda *t: sdc.ssd_chunk_intra_bwd_tc(
                *t, terms=1)),
        })
    else:
        steps.update({
            "plain backward x (1 + 1e-7 N(0,1))": (plain, jittered(1e-7)),
            "plain backward x (1 + 1e-6 N(0,1))": (plain, jittered(1e-6)),
            "float64 backward": (plain, lambda *t: tuple(
                g.float() for g in sdc.ssd_chunk_intra_bwd_f64(*t))),
        })
    steps["kernels"] = (sdc.ssd_chunk_intra_cuda, sdc.ssd_chunk_intra_bwd_cuda)
    saved = ops.ssd_chunk_intra
    print(f"mamba2-1.3b float32 gradients, batch {args.batch} x {args.prompt} tokens, seed "
          f"{args.seed} ({torch.cuda.get_device_name(dev)})")
    try:
        for n in args.layers:
            cut = dict(params, layers=tree_map(lambda t: t[:n], params["layers"]))
            model = build_model(dataclasses.replace(cfg, n_layers=n, param_dtype="float32",
                                                    compute_dtype="float32"), dev)
            names, leaves = zip(*flatten_with_path(cut))
            ref = None
            for name, (fwd, bwd) in steps.items():
                ops.ssd_chunk_intra = ops.ssd_chunk_intra_with(fwd, bwd)
                lv = [t.detach().requires_grad_(True) for t in leaves]
                loss, _ = model.loss(tree_unflatten(cut, lv), batch)
                grads = torch.autograd.grad(loss, lv)
                if ref is None:
                    ref = grads
                    print(f"  {n} layers: plain loss {float(loss.detach()):.6f}")
                    continue
                dists = [rel(g, r) for g, r in zip(grads, ref)]
                dist = [f"{k} {d:.3e}" for k, d in zip(names, dists)]
                print(f"  {n} layers, SSD {name}: loss {float(loss.detach()):.6f}; relative L2 from the "
                      f"plain gradient, largest {max(dists):.3e}, per leaf: " + ", ".join(dist),
                      flush=True)
                del grads
            del ref, model
            torch.cuda.empty_cache()
    finally:
        ops.ssd_chunk_intra = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad", action="store_true", help="the gradients' sensitivity")
    ap.add_argument("--layers", type=int, nargs="+", default=[12, 48])
    ap.add_argument("--tc", action="store_true",
                    help="with --grad: the backward's tensor-core arithmetic, emulated")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if args.grad:
        gradients(args, dev)
        return 0
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

    print(f"mamba2-1.3b float32 prefill logits, batch {args.batch}, prompts of {args.prompt} "
          f"tokens, seed {args.seed} ({torch.cuda.get_device_name(dev)})")
    for name, lg in logits.items():
        print(f"  SSD step {name}: relative L2 from the plain path {rel(lg, logits['plain']):.3e}, "
              f"from the float64 path {rel(lg, logits['float64']):.3e}; finite "
              f"{bool(torch.isfinite(lg).all())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
