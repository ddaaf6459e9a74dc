"""LM stack of the port: the dense, moe, ssm, vlm and enc-dec families'
layers, decoder stacks, serving entry points (prefill + KV-cache or
state decode), the dense and ssm families' training loss and the Model API."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
