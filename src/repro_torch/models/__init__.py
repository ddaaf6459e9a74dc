"""LM stack of the port: the dense family's layers, decoder stack,
serving entry points (prefill + KV-cache decode) and Model API."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
