"""InternLM2-20B [arXiv:2403.17297; hf] — dense, GQA kv=8, RoPE, SwiGLU."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    activation="swiglu",
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    activation="swiglu",
    param_dtype="float32",
    compute_dtype="float32",
)
