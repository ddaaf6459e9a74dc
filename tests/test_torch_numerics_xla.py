"""The port's emulations of XLA:CPU's float arithmetic against the JAX
package under `jit`, bitwise.

- `apply_rope`: XLA contracts each rotated half into one FMA over a
  rounded product; the port's `fma_f32` rounds the same way.
- `gelu_tanh` and `tanh_xla`: XLA computes `jax.nn.gelu` op by op (every
  op rounded in bfloat16; one FMA in float32) with its own rational tanh.
- `rope_angles` / `sincos_glibc`: XLA:CPU calls the C library's
  `sinf`/`cosf`, which the port reproduces in float64 and int64 torch
  operations, on both of glibc's reduction paths (below and above 120).
- `fma_f64`: an x86 double FMA, held against the C library's `fma`.
- `log1p_xla` and `exp_xla` / `exp2_xla`: XLA:CPU's inline float32 log1p
  and exp, read from the optimized IR and object code; `random.normal`'s
  erfinv runs over the first, the fault layer's retry rate over the
  second (`jnp.exp2(x)` is exp(x * 0.6931472), not exact at integers).

The C library is called through ctypes here only, as an oracle; the
port never calls it.
"""
import ctypes
import ctypes.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import numerics  # noqa: E402
from repro_torch.models import layers  # noqa: E402

POSITIONS = 32768  # rope angles up to 32767 rad: both of glibc's reduction paths


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a.view(np.uint32)


def _tbits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _libm():
    return ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")  # lint: allow=kernel-import


def _rope_params():
    """(rot, theta) of every dense config, full size and SMOKE."""
    out = set()
    for arch in registry.DENSE_ARCHS:
        for cfg in (registry.get_config(arch), registry.get_smoke_config(arch)):
            out.add((int(cfg.resolved_head_dim * cfg.rope_fraction), float(cfg.rope_theta)))
    return sorted(out)


@pytest.mark.parametrize("rot,theta", _rope_params())
def test_rope_angles_bitwise_equal_jit(rot, theta):
    pos = np.arange(POSITIONS, dtype=np.int32)
    jcos, jsin = jax.jit(lambda p: jlayers.rope_angles(p, rot, theta))(pos)
    cos, sin = layers.rope_angles(torch.from_numpy(pos), rot, theta)
    assert cos.dtype == sin.dtype == torch.float32
    np.testing.assert_array_equal(_tbits(cos), _bits(jcos))
    np.testing.assert_array_equal(_tbits(sin), _bits(jsin))


def test_rope_angles_bitwise_equal_constant_folded_jit():
    """The prefill's positions are a constant inside `jit`, so XLA folds
    the whole table at compile time; it still equals the port's."""
    cfg = registry.get_smoke_config("internlm2_20b")
    rot = int(cfg.resolved_head_dim * cfg.rope_fraction)
    jcos, jsin = jax.jit(lambda: jlayers.rope_angles(jnp.arange(4161), rot, 1e6))()
    cos, sin = layers.rope_angles(torch.arange(4161), rot, 1e6)
    np.testing.assert_array_equal(_tbits(cos), _bits(jcos))
    np.testing.assert_array_equal(_tbits(sin), _bits(jsin))


def test_sincos_glibc_equals_the_c_library():
    libm = _libm()
    for name in ("sinf", "cosf"):
        getattr(libm, name).restype = ctypes.c_float
        getattr(libm, name).argtypes = [ctypes.c_float]
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0.0, -0.0, 1e-30, 2.0 ** -12, 0.785, 0.7853982, 119.99, 120.0, 120.01,
                  -120.0, 1e4, 3.4e38, -3.4e38, np.pi, -np.pi / 2], np.float32),
        rng.uniform(-200, 200, 4000), rng.uniform(0, 70000, 4000),
        np.exp(rng.uniform(-40, 88, 4000)) * rng.choice([-1.0, 1.0], 4000),
    ]).astype(np.float32)
    sin, cos = numerics.sincos_glibc(torch.from_numpy(x))
    want_sin = np.array([libm.sinf(float(v)) for v in x], np.float32)
    want_cos = np.array([libm.cosf(float(v)) for v in x], np.float32)
    np.testing.assert_array_equal(_tbits(sin), want_sin.view(np.uint32))
    np.testing.assert_array_equal(_tbits(cos), want_cos.view(np.uint32))
    s, c = numerics.sincos_glibc(torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float32))
    assert torch.isnan(s).all() and torch.isnan(c).all()


def test_torch_cos_would_miss():
    """torch.cos is not the C library's cosf: the port cannot use it."""
    x = (np.arange(4096, dtype=np.float32)[:, None]
         * (1.0 / 10000.0 ** (np.arange(0, 16, 2) / 16)).astype(np.float32)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cos)(x))
    assert (_tbits(torch.cos(torch.from_numpy(x))) != _bits(want)).sum() > 100
    np.testing.assert_array_equal(_tbits(numerics.sincos_glibc(torch.from_numpy(x))[1]),
                                  _bits(want))


def test_inv_pio4_is_four_over_pi():
    """The 24 words of glibc's __inv_pio4: word i is floor(4/pi *
    2**(8i + 7)) mod 2**32, from pi computed with Python integers
    (Machin's formula, 256 bits; the words need 191)."""
    prec = 256

    def arctan_inv(n):  # arctan(1/n) * 2**prec
        total, term, k, sign = 0, (1 << prec) // n, 1, 1
        while term:
            total += sign * (term // k)
            term //= n * n
            k += 2
            sign = -sign
        return total

    pi = 16 * arctan_inv(5) - 4 * arctan_inv(239)  # pi * 2**prec
    four_over_pi = (4 << (2 * prec)) // pi  # 4/pi * 2**prec
    for i, word in enumerate(numerics.INV_PIO4):
        assert (four_over_pi >> (prec - 8 * i - 7)) & 0xFFFFFFFF == word, i


def test_fma_f64_equals_the_c_library():
    libm = _libm()
    libm.fma.restype = ctypes.c_double
    libm.fma.argtypes = [ctypes.c_double] * 3
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal(20000) for _ in range(3))
    c[:5000] = -(a[:5000] * b[:5000]) * (1 + 1e-3 * rng.standard_normal(5000))
    # exact midpoints of a*b + c's double rounding: a*b = 1 + 2**-53 + tiny
    a[5000:5100] = 1.0 + 2.0 ** -52
    b[5000:5100] = 1.0 - 2.0 ** -53 + rng.choice([-1, 1], 100) * 2.0 ** -104
    c[5000:5100] = 2.0 ** -30
    want = np.array([libm.fma(x, y, z) for x, y, z in zip(a, b, c)])
    got = numerics.fma_f64(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want.view(np.uint64))


def _grid(dtype):
    rng = np.random.default_rng(2)
    x = np.concatenate([np.linspace(-12, 12, 20001), rng.standard_normal(20000) * 3,
                        rng.standard_normal(2000) * 300, [0.0, -0.0, 1e-5, -1e-5, 40.0, -40.0]])
    return x.astype(np.float32), torch.from_numpy(x.astype(np.float32)).to(dtype)


def test_tanh_xla_bitwise_equal_jit():
    x, t = _grid(torch.float32)
    np.testing.assert_array_equal(_tbits(numerics.tanh_xla(t)), _bits(jax.jit(jnp.tanh)(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_bitwise_equal_jit(dtype):
    tdt = layers.dtype_of(dtype)
    x, t = _grid(tdt)
    want = jax.jit(jax.nn.gelu)(jnp.asarray(x).astype(dtype))
    got = layers.gelu_tanh(t)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_tbits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_apply_rope_bitwise_equal_jit(dtype, fraction):
    B, S, H, hd, theta = 2, 300, 4, 64, 1e6
    rot = int(hd * fraction)
    x = np.random.default_rng(3).standard_normal((B, S, H, hd)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jcos, jsin = jlayers.rope_angles(jnp.arange(S), rot, theta)
    want = jax.jit(lambda x, c, s: jlayers.apply_rope(x, c, s, fraction))(jx, jcos, jsin)
    tx = torch.from_numpy(x).to(layers.dtype_of(dtype))
    got = layers.apply_rope(tx, torch.from_numpy(np.array(jcos)),
                            torch.from_numpy(np.array(jsin)), fraction)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_tbits(got), _bits(want))


def _log1p_inputs():
    """At least 200,000 float32 inputs over both branches of XLA's log1p:
    -u*u for u uniform on (-1, 1) (erfinv's use), uniform on [-0.99, 5],
    log-uniform magnitudes 1e-30..1e10 of both signs, and every float
    within 4 ulps of the branch point 0.41421357 and of its negation,
    plus the specials."""
    rng = np.random.default_rng(21)
    u = rng.uniform(-1, 1, 100_000).astype(np.float32)
    mag = (10.0 ** rng.uniform(-30, 10, 60_000)).astype(np.float32)
    split = np.float32(0.41421357)
    near = split.view(np.int32) + np.arange(-4, 5, dtype=np.int32)
    near = near.view(np.float32)
    specials = np.array([0.0, -0.0, -1.0, -2.0, np.inf, -np.inf, np.nan, 1e-30, -1e-30],
                        np.float32)
    return np.concatenate([-u * u, rng.uniform(-0.99, 5, 60_000).astype(np.float32),
                           mag, -np.minimum(mag, np.float32(0.999)), near, -near, specials])


def test_log1p_xla_bitwise_equal_jit():
    x = _log1p_inputs()
    assert x.size >= 200_000
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = numerics.log1p_xla(torch.from_numpy(x)).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:8]
    small = np.abs(x) < np.float32(0.41421357)
    assert small.sum() > 50_000 and (~small).sum() > 50_000  # both branches


def test_torch_log1p_would_miss():
    """The function `random.normal` used before: torch's log1p, about 8%
    of erfinv's inputs off XLA's."""
    x = _log1p_inputs()[:100_000]
    want = np.asarray(jax.jit(jnp.log1p)(x))
    differ = torch.log1p(torch.from_numpy(x)).numpy().view(np.uint32) != want.view(np.uint32)
    assert 0.05 < differ.mean() < 0.12


@pytest.mark.parametrize("lo,hi", [(-87.0, 88.0), (-10.0, 10.0), (-1e-3, 1e-3)])
def test_exp_xla_bitwise_equal_jit(lo, hi):
    x = np.random.default_rng(int(hi)).uniform(lo, hi, 100_000).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(numerics.exp_xla(torch.from_numpy(x)).numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_exp2_xla_is_jits_exp2_not_a_power_of_two():
    """The retry release rate 2^-backoff (`src/repro/faults/model.py:232`)
    at backoff 0..64: XLA's exp(x * 0.6931472) bitwise, which is not the
    exact power of two at 13 and at every level from 15 on."""
    b = np.arange(65, dtype=np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.exp2(-v))(b))
    got = numerics.exp2_xla(-torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    inexact = np.nonzero(got != np.exp2(-b.astype(np.float64)).astype(np.float32))[0]
    assert inexact[0] == 13 and 14 not in inexact and set(range(15, 65)) <= set(inexact)
    assert not np.array_equal(torch.exp2(-torch.from_numpy(b)).numpy(), want)
