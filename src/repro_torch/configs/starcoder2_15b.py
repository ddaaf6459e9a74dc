"""StarCoder2-15B [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE,
LayerNorm + GELU MLP (non-gated), learned biasless embeddings."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    norm="layernorm",
    rope_theta=100000.0,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    activation="gelu",
    norm="layernorm",
    param_dtype="float32",
    compute_dtype="float32",
)
