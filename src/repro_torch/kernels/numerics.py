"""Exactly rounded float32 arithmetic for the plain kernel versions.

XLA:CPU contracts `a*b + c` into one fused multiply-add under `jit`, so
the JAX package's score pass and fill budget update round once. PyTorch
has no float32 FMA operator whose rounding it promises, so `fma_f32`
emulates one in float64 and corrects the one case where that rounds
twice. The CUDA kernels use `__fmaf_rn` at the same places.
"""
from __future__ import annotations

import math

import torch


def fma_f32(a, b, c) -> torch.Tensor:
    """Single-rounded float32 `a*b + c`, elementwise with broadcasting.

    The product of two float32 values is exact in float64, so the only
    error is in the sum: `s = fl64(p + c)` is rounded once to float64 and
    again to float32. The second rounding is wrong only when `s` lands
    exactly on a float32 midpoint while the exact sum does not (about
    one element in 2**27 on random data). TwoSum gives the exact error
    `err` of `s`; where `s` is a midpoint and `err != 0`, the result is
    the float32 neighbour on the side of the exact sum.
    """
    p = torch.as_tensor(a).double() * torch.as_tensor(b).double()
    q = torch.as_tensor(c).double()
    s = p + q
    bb = s - p
    err = (p - (s - bb)) + (q - bb)  # TwoSum: s + err == p + q exactly
    r = s.float()
    r64 = r.double()
    above = s > r64
    nb = torch.nextafter(r, torch.where(above, math.inf, -math.inf).float())
    # float32 neighbours and their midpoint are exact in float64
    mid = (s != r64) & (s - r64 == nb.double() - s)
    fix = mid & (err != 0) & ((err > 0) == above)
    return torch.where(fix, nb, r)
