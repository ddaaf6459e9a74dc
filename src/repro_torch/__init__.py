"""PyTorch / CUDA port of the carbon-neutralized task scheduler.

`repro_torch` mirrors the JAX package `repro` module for module, for the
slice that has been ported so far: the paper's slot loop (`simulate`,
`serve_loop`) with its two hand-written Hopper kernels, the DPP score
pass (`kernels/csrc/carbon_score.cu`) and the greedy budget fill
(`kernels/csrc/greedy_fill.cu`).

It imports torch and numpy only. Every entry point runs on the CUDA
device unless the caller passes `device="cpu"`, in which case each kernel
is replaced by its plain PyTorch version (the CPU tests do this).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
