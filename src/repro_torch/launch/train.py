"""Training CLI (counterpart of `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1_5_0_5b \
      --smoke --steps 50 --seq-len 256 --batch 8 --ckpt-dir /tmp/ckpt --device cpu

Runs a real training loop, AdamW with a cosine schedule over the
synthetic token stream, with checkpoint/restart: re-launching with the
same --ckpt-dir resumes from the latest step (the step is the stream's
cursor, so the batches continue exactly). On the CUDA card by default;
--device cpu runs the kernels' plain versions. Parameters are random,
from a seeded torch Generator. The dense and ssm families
(`transformer.require_trainable`), e.g. `--arch mamba2_1_3b --smoke`.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import make_batch_fn
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import require_trainable
from repro_torch.optim import AdamW, cosine_schedule, make_train_step
from repro_torch.pytree import tree_leaves


def train_loop(train_step, batch_fn, params, opt_state, start: int, stop: int, *, ckpt=None,
               ckpt_every: int = 25, log_every: int = 10, log=print):
    """Steps start..stop-1: batch_fn(step), then train_step. The host
    reads the metrics (a sync) only on the steps it logs; every
    `ckpt_every` steps a non-blocking checkpoint of {"params", "opt"}.
    Returns (params, opt_state, the last step's metrics)."""
    metrics = None
    t0 = time.time()
    for step in range(start, stop):
        params, opt_state, metrics = train_step(params, opt_state, batch_fn(step))
        if log is not None and (step % log_every == 0 or step == stop - 1):
            log(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e} "
                f"({time.time() - t0:.1f}s)")
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state}, blocking=False)
    return params, opt_state, metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    require_trainable(cfg)
    model = build_model(cfg, dev)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    train_step = make_train_step(model, opt)
    batch_fn = make_batch_fn(cfg, args.seq_len, args.batch, device=dev)

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)
    start = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        tree, start, _ = ckpt.restore({"params": params, "opt": opt_state})
        params, opt_state = tree["params"], tree["opt"]
        print(f"resumed from step {start}")

    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={dev}")
    params, opt_state, metrics = train_loop(
        train_step, batch_fn, params, opt_state, start, args.steps, ckpt=ckpt,
        ckpt_every=args.ckpt_every, log_every=args.log_every)
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt": opt_state})
        ckpt.wait()
    return float(metrics["loss"]) if metrics is not None else float("nan")


if __name__ == "__main__":
    main()
