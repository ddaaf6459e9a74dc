"""JAX's threefry2x32 random streams in PyTorch (the twin of `jax.random`).

The functions follow jax 0.9.0 with `jax_threefry_partitionable=True`
(`jax/_src/prng.py`, `jax/_src/random.py`), so the same key gives the same
bits as `jax.random` under that configuration:

  PRNGKey(seed)            [2]: (0, seed mod 2**32), as jax.random.PRNGKey
                           makes it with x64 off (`prng.py::threefry_seed`)
  threefry2x32(k, x)       the 20-round Threefry-2x32 hash (`prng.py:1092`)
  split(key, num)          key i = threefry(key, (0, i)): the fold-like
                           partitionable split (`prng.py:1138-1160`)
  fold_in(key, data)       threefry(key, (0, data)) (`prng.py:1163`)
  random_bits(key, shape)  counters (hi, lo) of the flat index
                           (`iota_2x32_shape`), bits = y0 ^ y1
  uniform / randint        `random.py:401-470`, `random.py:516-620`
  normal                   sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))
  bernoulli                uniform(key, shape) < p in p's float32 ('low'
                           mode, `random.py::_bernoulli`)

A key is a `[..., 2]` int64 tensor holding two uint32 values; leading
dimensions are lanes (F keys are one [F, 2] tensor), and every function
maps over them as `jax.vmap` would. The arithmetic is int64 masked to 32
bits, since torch's uint32 has no arithmetic on the CPU: additions are
masked after each add, rotations mask the shifted-out bits before the or,
and `randint`'s products (below 2**64, whose low 32 bits int64 keeps) are
masked straight after every multiply, as uint32 wraps them in JAX.

`normal` uses XLA's float32 ErfInv polynomial over XLA:CPU's own
`log1p` (`numerics.erfinv_xla`, `numerics.log1p_xla`), bitwise;
`poisson` follows
JAX's two samplers (Knuth below rate 10, Hormann's transformed
rejection above) with fixed iteration caps and torch's `log`/`lgamma`,
so it matches JAX in distribution, not bitwise; the uniforms of its
loops (JAX's keys and bits) are one draw a sampler (`ops.threefry_draw`
with `chain`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.numerics import erfinv_xla, fma_f32

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
SQRT2 = float(np.float32(np.sqrt(2.0)))
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_ONE_BITS = 0x3F800000  # float32 1.0


def PRNGKey(seed, device=DEFAULT_DEVICE) -> torch.Tensor:
    """The key of an int seed: (0, seed mod 2**32), int64 [2] on `device`.
    jax.random.PRNGKey reads a Python int as int64 and, with x64 off,
    keeps its low 32 bits (`threefry_seed` of an int32: the high word
    is 0), so negative seeds and seeds past 2**32 wrap."""
    seed = int(np.int64(seed))  # an int past int64 raises, as in JAX
    # (0, 1) * seed: made on the device, no copy from the host, no sync
    return torch.arange(2, dtype=torch.int64, device=resolve_device(device)) * (seed & M32)


def key_data(key) -> np.ndarray:
    """A key as a numpy uint32 array (`jax.random.key_data`'s form)."""
    return key.detach().cpu().numpy().astype(np.uint32)


def _rotl(v, r: int):
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter pair (x1, x2) under the
    key (k1, k2); int64 tensors of uint32 values, broadcast together.
    Returns the output pair (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & M32
    return x[0], x[1]


def _hash(key, hi, lo):
    """threefry2x32(key, (hi, lo)) with the key broadcast against the
    counters' trailing dimensions."""
    k1, k2 = key[..., 0], key[..., 1]
    extra = max(hi.dim(), lo.dim()) if torch.is_tensor(hi) or torch.is_tensor(lo) else 0
    k1 = k1.reshape(k1.shape + (1,) * extra)
    k2 = k2.reshape(k2.shape + (1,) * extra)
    return threefry2x32(k1, k2, hi, lo)


def split(key, num: int = 2) -> torch.Tensor:
    """`num` keys from `key`: [..., 2] -> [..., num, 2]."""
    lo = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y1, y2 = _hash(key, torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """The key of `key` and the 32-bit integer `data` (an int, or an
    integer tensor broadcast against the key's lanes, as a vmapped
    fold_in): [..., 2] -> [..., 2]."""
    if torch.is_tensor(data):
        d = data.to(device=key.device, dtype=torch.int64) & M32
        y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    else:
        d = int(data) & M32
        y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, d)
    return torch.stack([y1, y2], dim=-1)


def _shape(shape) -> tuple:
    return tuple(int(s) for s in ((shape,) if isinstance(shape, int) else shape))


def random_bits(key, shape=()) -> torch.Tensor:
    """32 random bits per element: [..., 2] -> [..., *shape] int64."""
    shape = _shape(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = _hash(key, idx >> 32, idx & M32)
    return (y1 ^ y2).reshape(key.shape[:-1] + shape)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _unit(bits) -> torch.Tensor:
    """[0, 1) floats from 32-bit draws: the top 23 bits as a mantissa of
    [1, 2), minus 1 (exact)."""
    return ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """float32 uniform on [minval, maxval): max(minval, fma(u, maxval -
    minval, minval)). `jax.random.uniform` is jitted even when called
    eagerly, and XLA:CPU contracts its `u * (maxval - minval) + minval`
    into one FMA, which differs from the two roundings on about 40% of
    draws at general bounds (none on [0, 1), where it is exact)."""
    return uniform_of_bits(random_bits(key, _shape(shape)), minval, maxval)


def uniform_of_bits(bits, minval=0.0, maxval=1.0) -> torch.Tensor:
    """`uniform`'s finish of 32-bit draws."""
    lo, hi = _f32(minval, bits.device), _f32(maxval, bits.device)
    return torch.maximum(lo, fma_f32(_unit(bits), hi - lo, lo))


def _wrap_i32(v):
    return ((v - _INT32_MIN) & M32) + _INT32_MIN


def randint_span(minval: int, maxval: int):
    """(minval, span, multiplier) of `randint`, as JAX derives them in
    int32: span = maxval - minval as uint32 (1 where maxval <= minval;
    a span that wraps to 0, from -2**31 to 2**31 - 1, leaves every `rem`
    without effect, which mod 2**32 does too); multiplier = (2**16 mod
    span)**2 mod 2**32 mod span. JAX refuses a bound outside int32 with
    x64 off, and so does this."""
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not _INT32_MIN <= v <= _INT32_MAX:
            raise OverflowError(f"randint bound {v} is outside int32")
    span = 1 if maxval <= minval else ((maxval - minval) & M32 or 1 << 32)
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    return minval, span, mult


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 uniform on [minval, maxval): two 32-bit draws (from the two
    halves of `split(key)`) combined mod the span, as JAX does."""
    shape = _shape(shape)
    k = split(key, 2)
    return randint_of_bits(random_bits(k[..., 0, :], shape), random_bits(k[..., 1, :], shape),
                           minval, maxval)


def randint_of_bits(higher, lower, minval: int, maxval: int) -> torch.Tensor:
    """`randint`'s finish of the 32-bit draws of its two keys."""
    mn, span, mult = randint_span(minval, maxval)
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    return _wrap_i32(mn + off).to(torch.int32)


def normal(key, shape=()) -> torch.Tensor:
    """float32 standard normal: sqrt(2) * erfinv(u), u uniform on
    [nextafter(-1, 0), 1) (the span rounds to 2.0, so the FMA is exact),
    with XLA's erfinv polynomial and log1p (`numerics.erfinv_xla`):
    bitwise `jax.random.normal`."""
    return normal_of_bits(random_bits(key, _shape(shape)))


def normal_of_bits(bits) -> torch.Tensor:
    """`normal`'s finish of 32-bit draws."""
    return SQRT2 * erfinv_xla(uniform_of_bits(bits, NORMAL_LO, 1.0))


def bernoulli(key, p, shape=()) -> torch.Tensor:
    """bool draws of probability p (a Python float, float32 in JAX with
    x64 off): `uniform(key, shape) < float32(p)`, as jax.random.bernoulli's
    default 'low' mode computes it (p 0 gives no True, p 1 all True)."""
    return uniform(key, shape) < float(np.float32(p))


# Iteration caps of the fixed-length samplers: P(Poisson(10) >= 64) and
# the chance that 24 rejection rounds all reject (each accepts with
# probability above 0.85) are both below 1e-19.
_KNUTH_ITERS = 64
_REJECTION_ITERS = 24


def _poisson_knuth(lam, u):
    """Knuth's sampler on its rounds' uniforms u [R, *shape]: the count
    of rounds that start with the running product of u above exp(-lam),
    less one. The logs are summed by `cumsum` (JAX adds them one round
    at a time in float32)."""
    log_prod = torch.cumsum(torch.log(u), dim=0)
    before = torch.cat([torch.zeros_like(log_prod[:1]), log_prod[:-1]])
    return (before > -lam).sum(dim=0) - 1


def _poisson_rejection(lam, u, v):
    """Hormann's transformed rejection on its rounds' uniforms u, v
    [R, *shape], every round at once."""
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    u = u - 0.5
    u_shifted = 0.5 - torch.abs(u)
    k = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
    s = torch.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
    t = -lam + k * log_lam - torch.lgamma(k + 1)
    accept1 = (u_shifted >= 0.07) & (v <= v_r)
    reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
    accept = accept1 | (~reject & (s <= t))
    # JAX's loop runs a round while any element waits, and a later accept
    # overwrites an earlier one: round r counts unless every element
    # accepted in an earlier round
    rounds = accept.shape[0]
    seen = torch.cumsum(accept.reshape(rounds, -1).to(torch.int32), dim=0) > 0
    done = torch.cat([torch.zeros_like(seen[:1, 0]), seen[:-1].all(dim=1)])
    accept = accept & ~done.reshape((rounds,) + (1,) * (accept.dim() - 1))
    idx = torch.arange(rounds, device=lam.device).reshape(done.shape + (1,) * (accept.dim() - 1))
    last = torch.where(accept, idx, -1).amax(dim=0)
    k_last = torch.gather(k, 0, last.clamp_min(0)[None])[0]
    return torch.where(last >= 0, k_last, -1.0).to(torch.int64)


def poisson(key, lam, shape=None, t=None) -> torch.Tensor:
    """int32 Poisson draws of rate `lam` from one key, folded with the
    slot `t` when it is given (`shape` defaults to lam's), by JAX's
    samplers and key walk: Knuth below rate 10, transformed rejection
    from 10 up, 0 at rate 0. The uniforms of every round of a sampler's
    loop are one `ops.threefry_draw` (one launch on the card)."""
    from repro_torch.kernels import ops  # ops' draw module imports this one

    if key.dim() != 1:
        raise ValueError("poisson takes one key of shape [2]")
    lam = _f32(lam, key.device)
    shape = tuple(lam.shape) if shape is None else _shape(shape)
    lam = torch.broadcast_to(lam, shape)
    n = math.prod(shape)
    if n == 0:
        return torch.zeros(shape, dtype=torch.int32, device=key.device)
    u_knuth = ops.threefry_draw(key, t, n, chain=(_KNUTH_ITERS, 1))
    u_rej = ops.threefry_draw(key, t, n, chain=(_REJECTION_ITERS, 2))
    use_knuth = torch.isnan(lam) | (lam < 10)
    knuth = _poisson_knuth(torch.where(use_knuth, lam, 0.0),
                           u_knuth.reshape((_KNUTH_ITERS,) + shape))
    rejection = _poisson_rejection(torch.where(use_knuth, 1e5, lam),
                                   u_rej[:, 0].reshape((_REJECTION_ITERS,) + shape),
                                   u_rej[:, 1].reshape((_REJECTION_ITERS,) + shape))
    out = torch.where(use_knuth, knuth, rejection)
    return torch.where(lam == 0, 0, out).to(torch.int32)
