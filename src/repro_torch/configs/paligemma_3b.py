"""PaliGemma-3B [arXiv:2407.07726; hf] — SigLIP vision frontend (STUB:
input_specs provides precomputed patch embeddings) + Gemma-2B decoder:
MQA (kv=1), head_dim 256, GeGLU, prefix-LM attention over the image
prefix, tied embeddings."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    activation="geglu",
    tie_embeddings=True,
    prefix_len=256,
    frontend_stub="patch",
)

SMOKE = ModelConfig(
    name="paligemma-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    activation="geglu",
    tie_embeddings=True,
    prefix_len=8,
    frontend_stub="patch",
    param_dtype="float32",
    compute_dtype="float32",
)
