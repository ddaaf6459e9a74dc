"""GLM4-9B [hf:THUDM/glm-4-9b] — dense, GQA kv=2, partial RoPE (half the
head dim rotates), SwiGLU."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    activation="swiglu",
    rope_fraction=0.5,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="glm4-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=224,
    vocab_size=512,
    activation="swiglu",
    rope_fraction=0.5,
    param_dtype="float32",
    compute_dtype="float32",
)
