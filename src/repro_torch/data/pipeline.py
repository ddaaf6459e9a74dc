"""Deterministic synthetic data pipeline (counterpart of
`repro.data.pipeline`).

`TokenStream.batch(step)` is a pure function of (seed, step), drawn with
the port's twin of `jax.random` (`repro_torch.random`), so the tokens and
labels are the JAX package's bit for bit: every host or shard slices the
same logical stream, a restart resumes mid-stream exactly (the step is
the cursor), and each task type gets its own stream. `make_batch_fn`
adds a vlm's image-patch embeddings or an enc-dec model's frame
embeddings (float32 normals times 0.02, as JAX draws them eagerly), and
`TaskArrivals` the orchestrator's a_m(t), numpy as in JAX. Batches are
made on `device`, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Infinite synthetic LM stream: batch(step) is a pure function."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so losses are learnable, not pure noise
    n_patterns: int = 64
    pattern_len: int = 16
    device: object = DEFAULT_DEVICE

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"}: [B, S] int32; each sequence interleaves a
        repeated pattern with 15% noise tokens, labels are the next token
        (-1 at the end)."""
        dev = resolve_device(self.device)
        key = jr.fold_in(jr.PRNGKey(self.seed, dev), step)
        k1, k2, k3 = jr.split(key, 3).unbind(0)
        B, S = self.global_batch, self.seq_len
        pat_ids = jr.randint(k1, (B, 1), 0, self.n_patterns)
        base = jr.randint(jr.fold_in(jr.PRNGKey(self.seed + 1, dev), 0),
                          (self.n_patterns, self.pattern_len), 0, self.vocab_size)
        reps = (S + self.pattern_len - 1) // self.pattern_len
        pattern = base[pat_ids[:, 0].long()].repeat(1, reps)[:, :S]
        noise = jr.randint(k2, (B, S), 0, self.vocab_size)
        is_noise = jr.bernoulli(k3, 0.15, (B, S))
        tokens = torch.where(is_noise, noise, pattern).to(torch.int32)
        labels = torch.cat([tokens[:, 1:], torch.full((B, 1), -1, dtype=torch.int32, device=dev)],
                           dim=1)
        return {"tokens": tokens, "labels": labels}

    def shard_for_host(self, batch: Dict[str, torch.Tensor], host: int,
                       n_hosts: int) -> Dict[str, torch.Tensor]:
        """Host `host`'s rows of a global batch, of n_hosts equal shards."""
        if self.global_batch % n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split into {n_hosts} "
                             "hosts")
        per = self.global_batch // n_hosts
        return {name: x[host * per:(host + 1) * per] for name, x in batch.items()}


def make_batch_fn(cfg, seq_len: int, global_batch: int, seed: int = 0, device=DEFAULT_DEVICE):
    """Batch function step -> batch for any ported family (stub frontends
    get random embeddings, as the JAX package's input specs do): a vlm's
    "patches" [B, prefix_len, D] and an enc-dec model's "frames" [B,
    source_len, D], float32."""
    dev = resolve_device(device)
    stream = TokenStream(cfg.vocab_size, seq_len, global_batch, seed, device=dev)

    def batch(step: int) -> Dict[str, torch.Tensor]:
        b = stream.batch(step)
        key = jr.fold_in(jr.PRNGKey(seed + 7, dev), step)
        if cfg.is_encoder_decoder:
            frames = jr.normal(key, (global_batch, cfg.source_len, cfg.d_model)) * 0.02
            return {"frames": frames, "tokens": b["tokens"], "labels": b["labels"]}
        if cfg.family == "vlm":
            s_text = seq_len - cfg.prefix_len
            patches = jr.normal(key, (global_batch, cfg.prefix_len, cfg.d_model)) * 0.02
            return {"patches": patches, "tokens": b["tokens"][:, :s_text],
                    "labels": b["labels"][:, :s_text]}
        return b

    return batch


@dataclasses.dataclass(frozen=True)
class TaskArrivals:
    """a_m(t) ~ U{0..amax} (paper §V) over M task types; pure in (seed, t).
    A numpy float32 [M] on the host, as the JAX package's."""

    M: int
    amax: int = 400
    seed: int = 0

    def __call__(self, t: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, t))
        return rng.integers(0, self.amax + 1, self.M).astype(np.float32)
