"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — dense-MoE
hybrid: every layer has a dense residual FFN *in parallel* with a
128-expert top-2 MoE. GQA kv=8."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    activation="swiglu",
    n_experts=128,
    n_experts_active=2,
    moe_d_ff=4864,
    moe_dense_residual=True,
)

SMOKE = ModelConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
    n_experts=8,
    n_experts_active=2,
    moe_path="dense",
    ep_axis=2,
    moe_d_ff=128,
    moe_dense_residual=True,
    param_dtype="float32",
    compute_dtype="float32",
)
