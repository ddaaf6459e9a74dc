"""PyTorch / CUDA port of the carbon-neutralized task scheduler.

`repro_torch` mirrors the JAX package `repro` module for module, for the
slices that have been ported so far: the paper's slot loop (`simulate`,
`serve_loop`), the WAN route-aware loop (`network`, `simulate(graph=)`)
and LM serving for the dense and SSM families (`models`, `launch.serve`),
with six hand-written Hopper kernels under `kernels/csrc/`: the DPP
score pass, the WAN route-score pass, the greedy budget fill, GQA flash
attention (prefill), split-S flash decoding (decode) and the Mamba-2 SSD
intra-chunk step (SSM prefill).

It imports torch and numpy only. Every entry point runs on the CUDA
device unless the caller passes `device="cpu"`, in which case each kernel
is replaced by its plain PyTorch version (the CPU tests do this).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
