"""LM stack of the port: the dense, moe and ssm families' layers, decoder
stacks, serving entry points (prefill + KV-cache or state decode) and
Model API."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
