"""PyTorch / CUDA port of the carbon-neutralized task scheduler.

`repro_torch` mirrors the JAX package `repro` module for module, for the
slices that have been ported so far: JAX's threefry random streams
(`random`), the paper's slot loop (`simulate`, `serve_loop`), the V
sweep and the scenario fleet (`simulate_vsweep`, `simulate_fleet`,
`configs.fleet_scenarios.build_fleet`), the WAN route-aware loop
(`network`, `simulate(graph=)`), the forecast layer (`forecast`), the
fault layer (`faults`, `simulate(faults=)`, fault lanes in a fleet) and
LM serving (`models`, `launch.serve`), and training for the dense
family (`data`, `optim`, `checkpoint`, `launch.train`, and the
`orchestrator` that schedules training jobs by Algorithm 1), with
hand-written Hopper kernels under `kernels/csrc/`: among them the DPP
score pass, the WAN route-score pass, the greedy budget fill, the
threefry draw, GQA flash attention (prefill) and its backward
(training), split-S flash decoding (decode) and the Mamba-2 SSD
intra-chunk step (SSM prefill).

It imports torch and numpy only. Every entry point runs on the CUDA
device unless the caller passes `device="cpu"`, in which case each kernel
is replaced by its plain PyTorch version (the CPU tests do this).
"""
from repro_torch import random
from repro_torch.core import FleetScenario, simulate_fleet, simulate_vsweep, stack_scenarios
from repro_torch.configs.fleet_scenarios import build_fleet, with_faults
from repro_torch.device import resolve_device

__all__ = ["FleetScenario", "build_fleet", "random", "resolve_device", "simulate_fleet",
           "simulate_vsweep", "stack_scenarios", "with_faults"]
