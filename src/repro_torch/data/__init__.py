"""Deterministic synthetic data streams (counterpart of `repro.data`)."""
from repro_torch.data.pipeline import TaskArrivals, TokenStream, make_batch_fn

__all__ = ["TaskArrivals", "TokenStream", "make_batch_fn"]
