"""Serving CLI (counterpart of `repro.launch.serve`): batched prefill
and greedy decode, for the dense and moe families (KV caches) and the
ssm family (state caches).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_moe_a2_7b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_1_3b --smoke --device cpu

Runs on the CUDA card by default; --device cpu runs the kernels' plain
versions. Parameters are random, from a seeded torch Generator.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import build_model


def greedy_generate(model, params, prompts, gen_len: int, cache_len: int) -> torch.Tensor:
    """prompts [B,S] int32 on the model's device -> [B, gen_len] int32
    tokens on the device. The cache is whatever the model's prefill
    returns (cache_len sizes a KV cache; an SSM cache has a fixed size).
    Every decode step and argmax stays on the device: the loop never
    waits for the host."""
    resolve_device(model.device)
    if prompts.device != model.device:
        raise ValueError(f"greedy_generate: prompts on {prompts.device}, model on {model.device}")
    logits, cache = model.prefill(params, {"tokens": prompts}, cache_len=cache_len)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    out = []
    for _ in range(gen_len):
        out.append(tok)
        logits, cache = model.decode_step(params, tok, cache)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    rng = np.random.default_rng(0)
    n_batches = (args.requests + args.batch - 1) // args.batch
    total_tok = 0
    t0 = time.time()
    for b in range(n_batches):
        prompts = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32),
            device=dev)
        toks = greedy_generate(model, params, prompts, args.gen_len,
                               cache_len=args.prompt_len + args.gen_len + 1).cpu()
        total_tok += toks.numel()
        print(f"batch {b}: generated {tuple(toks.shape)} first tokens {toks[0, :8].numpy()}")
    dt = time.time() - t0
    print(f"served {args.requests} reqs, {total_tok} tokens on {dev} "
          f"in {dt:.1f}s ({total_tok / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
