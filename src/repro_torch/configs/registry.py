"""Architecture registry of the port (counterpart of
`repro.configs.registry`): its own copy of `ModelConfig`, `SHAPES` and
the ten arch ids.

Every ported architecture has a module `repro_torch/configs/<id>.py`
exporting `CONFIG` (full size) and `SMOKE` (a reduced config of the same
family, used by the CPU tests), copied from the JAX package as they are.
The dense family (GLM-4-9B, Qwen1.5-0.5B, InternLM2-20B, StarCoder2-15B),
the MoE family (Qwen1.5-MoE-A2.7B, Arctic) and the SSM family
(Mamba2-1.3B) are ported; the other families raise NotImplementedError
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

# Input-shape cells assigned to the LM family (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

ARCH_IDS = (
    "starcoder2_15b",
    "internlm2_20b",
    "glm4_9b",
    "qwen1_5_0_5b",
    "arctic_480b",
    "qwen2_moe_a2_7b",
    "paligemma_3b",
    "seamless_m4t_medium",
    "mamba2_1_3b",
    "jamba_1_5_large_398b",
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int  # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu | relu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # glm4 uses partial rotary
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0  # routed top-k
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # expert hidden dim (0 => d_ff)
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel
    moe_every: int = 1  # apply MoE each `moe_every` layers (jamba: 2)
    moe_path: str = "capacity"  # capacity (production) | dense (exact oracle)
    moe_capacity_factor: float = 1.25
    ep_axis: int = 16  # experts padded to a multiple of this (EP mesh axis)
    # --- SSM (mamba2 / jamba) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid ---
    attn_every: int = 0  # jamba: one attention layer per 8 layers
    # --- enc-dec / frontends ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    source_len: int = 4096  # encoder input length for enc-dec dry-run cells
    prefix_len: int = 0  # vlm: image-patch prefix (prefix-LM masking)
    frontend_stub: str = ""  # "patch" | "frames" | ""
    # --- numerics / execution ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # The fields below steer the JAX package's execution (remat, query
    # chunking, the Pallas switch, scan unrolling for its dry-run). They
    # are kept so a config compares field for field with the reference;
    # the port's inference path reads none of them.
    remat: str = "block"  # none | block
    attn_chunk: int = 1024  # query-chunked (flash-style) attention block
    logit_chunk: int = 2048  # chunked unembed+CE
    use_pallas: bool = False
    unroll_scans: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ---- parameter counting (roofline MODEL_FLOPS uses these) ----
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        qkv = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * hd
        out = self.n_heads * hd * self.d_model
        return qkv + out

    def _mlp_params(self, d_ff: int) -> int:
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * self.d_model * d_ff

    def _ssm_params(self) -> int:
        di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
        in_proj = self.d_model * (2 * di + 2 * ds + nh)  # x,z,B,C,dt
        out_proj = di * self.d_model
        conv = self.ssm_conv * (di + 2 * ds)
        return in_proj + out_proj + conv + 2 * nh  # + A_log, D

    def _layer_counts(self) -> Tuple[int, int]:
        """(n_attention_layers, n_ssm_layers) over the decoder stack."""
        if self.family == "ssm":
            return 0, self.n_layers
        if self.family == "hybrid":
            n_attn = self.n_layers // self.attn_every
            return n_attn, self.n_layers - n_attn
        return self.n_layers, 0

    def total_params(self) -> int:
        n_attn, n_ssm = self._layer_counts()
        p = n_attn * self._attn_params() + n_ssm * self._ssm_params()
        moe_ff = self.moe_d_ff or self.d_ff
        if self.n_experts:
            n_moe_layers = self.n_layers // self.moe_every
            n_dense_layers = self.n_layers - n_moe_layers
            p += n_moe_layers * (
                self.n_experts * self._mlp_params(moe_ff)
                + self.n_shared_experts * self._mlp_params(moe_ff)
                + self.d_model * self.n_experts  # router
                + (self._mlp_params(self.d_ff) if self.moe_dense_residual else 0)
            )
            p += n_dense_layers * self._mlp_params(self.d_ff)
        elif self.d_ff:
            p += self.n_layers * self._mlp_params(self.d_ff)
        if self.is_encoder_decoder:
            # encoder stack + cross-attention in decoder
            p += self.n_encoder_layers * (
                self._attn_params() + self._mlp_params(self.d_ff)
            )
            p += self.n_layers * self._attn_params()  # cross-attn
        p += self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        return p

    def active_params(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.total_params()
        n_attn, n_ssm = self._layer_counts()
        p = n_attn * self._attn_params() + n_ssm * self._ssm_params()
        moe_ff = self.moe_d_ff or self.d_ff
        n_moe_layers = self.n_layers // self.moe_every
        n_dense_layers = self.n_layers - n_moe_layers
        p += n_moe_layers * (
            self.n_experts_active * self._mlp_params(moe_ff)
            + self.n_shared_experts * self._mlp_params(moe_ff)
            + self.d_model * self.n_experts
            + (self._mlp_params(self.d_ff) if self.moe_dense_residual else 0)
        )
        p += n_dense_layers * self._mlp_params(self.d_ff)
        p += self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        return p

    def supports_shape(self, shape: str) -> Tuple[bool, str]:
        """Whether a dry-run cell applies (see DESIGN.md §Arch-applicability)."""
        if shape == "long_500k" and self.family not in ("ssm", "hybrid"):
            return False, "long_500k needs sub-quadratic attention; " \
                "this arch is pure full-attention (skip per brief)"
        return True, ""


DENSE_ARCHS = ("starcoder2_15b", "internlm2_20b", "glm4_9b", "qwen1_5_0_5b")
MOE_ARCHS = ("arctic_480b", "qwen2_moe_a2_7b")
SSM_ARCHS = ("mamba2_1_3b",)
NOT_PORTED = {  # items of ROADMAP Queue 1's list of next slices
    "jamba_1_5_large_398b": "hybrid attention + SSM + MoE (ROADMAP Queue 1, next slices 3.3)",
    "paligemma_3b": "VLM prefix-LM (ROADMAP Queue 1, next slices 3.4)",
    "seamless_m4t_medium": "enc-dec (ROADMAP Queue 1, next slices 3.5)",
}


def _module(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}: the {NOT_PORTED[arch_id]} family is not ported to repro_torch yet")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
