"""The Model API of the port (counterpart of `repro.models.model`), for
the dense, moe and ssm families.

`build_model(cfg, device)` gives a `Model` with
  init(generator) -> params
  prefill(params, batch, cache_len) -> (logits, cache)
  decode_step(params, token, cache) -> (logits, cache)
  cache_specs(seq_len, batch) -> {name: (shape, dtype)}
  init_cache(batch, seq_len) -> zero cache on the device
The device defaults to CUDA and is checked when the model is built: with
no card, build_model raises unless it is given device="cpu".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import serving, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters on the model's device, from a torch
        Generator on that device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"init: generator on {generator.device}, model on {self.device}")
        return transformer.init_params(generator, self.cfg)

    def prefill(self, params, batch, cache_len=None):
        return serving.prefill(params, batch, self.cfg, cache_len)

    def decode_step(self, params, token, cache):
        return serving.decode_step(params, token, cache, self.cfg)

    def cache_specs(self, seq_len: int, batch: int) -> Dict[str, tuple]:
        cfg = self.cfg
        transformer.require_ported(cfg)
        cd = L.dtype_of(cfg.compute_dtype)
        if cfg.family == "ssm":  # fixed size: seq_len is not read
            return {
                "ssm": ((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                        torch.float32),
                "conv": ((cfg.n_layers, batch, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_state), cd),
            }
        kv = ((cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.resolved_head_dim), cd)
        return {"k": kv, "v": kv, "pos": ((), torch.int32)}

    def init_cache(self, batch: int, seq_len: int) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in self.cache_specs(seq_len, batch).items()}


def build_model(cfg: ModelConfig, device=DEFAULT_DEVICE) -> Model:
    transformer.require_ported(cfg)
    return Model(cfg, resolve_device(device))
