"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, MHA (kv=16), QKV bias,
SwiGLU, tied embeddings."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=176,
    vocab_size=512,
    activation="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
