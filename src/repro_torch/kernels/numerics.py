"""Float32 arithmetic in the JAX package's rounding, for the plain
kernel versions.

XLA:CPU contracts `a*b + c` into one fused multiply-add under `jit`, so
the JAX package's score pass and fill budget update round once. PyTorch
has no float32 FMA operator whose rounding it promises, so `fma_f32`
emulates one in float64 and corrects the one case where that rounds
twice. The CUDA kernels use `__fmaf_rn` at the same places.

XLA:CPU also sums a `jnp.cumsum` in its own blocked order, which
`cumsum_xla` follows (`torch.cumsum` runs one sequential sum).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SCAN_BLOCK = 16  # the block length of XLA:CPU's compiled cumsum (read from its HLO)


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


def cumsum_xla(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum along `dim` in the order XLA:CPU compiles
    `jnp.cumsum` to (read from the compiled HLO; bitwise equal to
    `jit(jnp.cumsum)` at every length tested, on any axis).

    Up to 16 elements: one running sum, left to right. Longer: zeros
    padded at the end to whole blocks of 16, a running sum inside each
    block, the same rule applied to the block totals (the last entry of
    each block), and each block's running sums plus the prefix of the
    blocks before it (0 for the first). At length 256 that is 16 blocks
    and one level of 16 totals; at 257 it recurses once more.
    """
    return _scan(x.movedim(dim, -1)).movedim(-1, dim)


def _scan(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    nb = -(-n // SCAN_BLOCK)
    blocks = _scan(F.pad(x, (0, nb * SCAN_BLOCK - n)).reshape(*x.shape[:-1], nb, SCAN_BLOCK))
    before = F.pad(_scan(blocks[..., -1])[..., :-1], (1, 0))  # exclusive prefix of the totals
    return (blocks + before[..., None]).reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :n]
