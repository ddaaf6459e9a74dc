"""SeamlessM4T-medium [arXiv:2308.11596; hf] — encoder-decoder multimodal
backbone. The speech frontend is a STUB: the prefill batch holds
precomputed frame embeddings "frames" [B, source_len, d_model]. 12-layer
encoder and 12-layer decoder, each decoder layer with cross-attention
over the encoder's output; LayerNorm with bias, GELU (tanh form,
ungated). Both stacks add a sinusoidal position table to their inputs,
and both stacks' self-attention also rotates q and k (rope_fraction 1.0,
as the JAX model's `gqa_attention` and `decode_attention` do); the
cross-attention does not rotate. The vocabulary stays 256,206 (nothing
pads it), with untied embedding and unembedding."""
from repro_torch.configs.registry import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    activation="gelu",
    norm="layernorm",
    is_encoder_decoder=True,
    n_encoder_layers=12,
    source_len=4096,
    frontend_stub="frames",
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    activation="gelu",
    norm="layernorm",
    is_encoder_decoder=True,
    n_encoder_layers=2,
    source_len=32,
    frontend_stub="frames",
    param_dtype="float32",
    compute_dtype="float32",
)
