"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts
top-4 + 4 shared experts, MHA kv=16. Expert count padded 60 -> 64 on the
EP mesh axis (pads masked out of routing)."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,  # shared-path FFN capacity
    vocab_size=151936,
    activation="swiglu",
    n_experts=60,
    n_experts_active=4,
    n_shared_experts=4,
    moe_d_ff=1408,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    activation="swiglu",
    n_experts=6,
    n_experts_active=2,
    n_shared_experts=2,
    moe_path="dense",
    ep_axis=2,
    moe_d_ff=96,
    param_dtype="float32",
    compute_dtype="float32",
)
