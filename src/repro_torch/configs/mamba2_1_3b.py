"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSM with the SSD
(state-space duality) chunked algorithm. 48 layers, d_model 2048,
d_inner = 2*d_model, head_dim 64, d_state 128."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=8,
    param_dtype="float32",
    compute_dtype="float32",
)
