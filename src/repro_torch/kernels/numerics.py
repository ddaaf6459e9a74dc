"""Float32 arithmetic in the JAX package's rounding, for the plain
kernel versions.

XLA:CPU contracts `a*b + c` into one fused multiply-add under `jit`, so
the JAX package's score pass and fill budget update round once. PyTorch
has no float32 FMA operator whose rounding it promises, so `fma_f32`
emulates one in float64 and corrects the one case where that rounds
twice. The CUDA kernels use `__fmaf_rn` at the same places.

XLA:CPU also sums a `jnp.cumsum` in its own blocked order, which
`cumsum_xla` follows (`torch.cumsum` runs one sequential sum); computes
float32 `tanh` with its own rational approximation (`tanh_xla`); and
calls the C library's `sinf`/`cosf` for float32 `sin`/`cos`, which
`sincos_glibc` reproduces in float64 and int64 operations; builds
`erfinv` from its own polynomial (`erfinv_xla`); inlines its own
float32 `log1p` and `exp` (`log1p_xla`, `exp_xla`, `exp2_xla`); and
sums a `jnp.sum` over one or two trailing axes in the order its compiled
loops take, which `sum_plan` and `plan_sum` follow.

Every function here is a chain of separate elementwise torch calls, so
it gives the same bits on the CPU and on the card: one torch call does
one IEEE operation, which no compiler can contract with another.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

SCAN_BLOCK = 16  # the block length of XLA:CPU's compiled cumsum (read from its HLO)
SUM_BLOCK = 32  # the window of XLA:CPU's reductions (read from the HLO)


# Set by `repro_torch.analysis.sanitize` while it checks a run: called as
# OP_HOOK(fn, args, kwargs) in place of each emulation marked `one_op`,
# which stands for one operation of XLA's (its intermediates, such as
# TwoSum's inf - inf on an infinite sum, are not the program's values).
OP_HOOK = None


def one_op(fn):
    @functools.wraps(fn)
    def op(*args, **kwargs):
        hook = OP_HOOK
        return fn(*args, **kwargs) if hook is None else hook(fn, args, kwargs)

    return op


_F32_MID_MASK = (1 << 29) - 1  # the float64 fraction bits below float32's 23
_F32_MID = 1 << 28  # ... as they stand in a float32 midpoint: 1 then zeros


def _fma_f32(a, b, c) -> torch.Tensor:
    def f64(x):
        return x.double() if torch.is_tensor(x) else float(x)

    p = f64(a) * f64(b)
    q = f64(c)
    s = p + q
    bb = s - p
    err = (p - (s - bb)) + (q - bb)  # TwoSum: s + err == p + q exactly
    mid = (s.view(torch.int64) & _F32_MID_MASK) == _F32_MID
    return torch.where(mid, torch.nextafter(s, s + err * 1e300), s).float()


def _grad_to(g, like):
    """g summed over the broadcast dimensions of an input of `like` =
    (shape, dtype), in that dtype (None for a Python float's)."""
    if like is None:
        return None
    shape, dtype = like
    return g.sum_to_size(shape).to(dtype)


class _FmaF32(torch.autograd.Function):
    """`fma_f32` under autograd: the derivative of a*b + c (g*b, g*a, g,
    each a float32 product rounded to its input's dtype, as JAX's
    derivative of the unfused float32 expression is). Autograd through
    the emulation itself would be wrong where its float64 sum lands on a
    float32 midpoint (torch.nextafter's derivative is not the identity),
    which bf16 inputs hit on many elements, and it would keep every
    float64 intermediate for the backward."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(*(x if torch.is_tensor(x) else None for x in (a, b)))
        ctx.floats = tuple(None if torch.is_tensor(x) else float(x) for x in (a, b))
        ctx.likes = tuple((x.shape, x.dtype) if torch.is_tensor(x) else None for x in (a, b, c))
        return _fma_f32(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = (t if t is not None else f for t, f in zip(ctx.saved_tensors, ctx.floats))
        la, lb, lc = ctx.likes
        return _grad_to(g * b, la), _grad_to(g * a, lb), _grad_to(g, lc)


@one_op
def fma_f32(a, b, c) -> torch.Tensor:
    """Single-rounded float32 `a*b + c`, elementwise with broadcasting
    (a or b a tensor; any of them may be a Python float).

    The product of two float32 values is exact in float64, so the only
    error is in the sum: `s = fl64(p + c)` is rounded once to float64 and
    again to float32. The second rounding is wrong only when `s` lands
    exactly on a float32 midpoint while the exact sum does not (about
    one element in 2**27 on random data). TwoSum gives the exact error
    `err` of `s`; a midpoint `s` moved one float64 step towards `err`
    rounds to the float32 on the side of the exact sum (err = 0 leaves
    the tie to ties-to-even). The midpoint test reads the float64 bits,
    which holds for results in float32's normal range and for zero.
    Differentiable (`_FmaF32`) where autograd records.
    """
    if torch.is_grad_enabled() and any(torch.is_tensor(x) and x.requires_grad for x in (a, b, c)):
        return _FmaF32.apply(a, b, c)
    return _fma_f32(a, b, c)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)  # s + err == a + b exactly


def _split(a):
    c = a * 134217729.0  # 2**27 + 1: Veltkamp's split into two 26-bit halves
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl  # p + err == a*b exactly


@one_op
def fma_f64(a, b, c) -> torch.Tensor:
    """Single-rounded float64 `a*b + c`, as an x86 `vfmadd` gives it.

    Dekker's product and TwoSum carry a*b + c exactly as s + u + v with
    |u| near an ulp of s and |v| near an ulp of u (for operands whose sum
    does not cancel, which holds for every call in this module); s + u
    rounds right unless it falls exactly on a midpoint, where v decides,
    as in `fma_f32`. Inputs must stay far from overflow and underflow.
    """
    p, e = _two_prod(a, b)
    s, t = _two_sum(p, c)
    u, v = _two_sum(t, e)
    r, w = _two_sum(s, u)  # a*b + c == r + w + v exactly
    nb = torch.nextafter(r, torch.where(w > 0, math.inf, -math.inf).to(r.dtype))
    fix = (w != 0) & (nb - r == 2 * w) & (v != 0) & ((v > 0) == (w > 0))
    return torch.where(fix, nb, r)


# XLA:CPU's float32 tanh (its elemental IR emitter's rational approximation,
# read from the optimized LLVM IR and the object code of jit(jnp.tanh),
# jax 0.9.0): |x| < 0.0004 returns x, |x| >= 20 returns sign(x), and
# otherwise x clamped to [-7.99..., 7.99...] goes through
# x * P(x^2) / Q(x^2), each polynomial in Horner form with one FMA a step.
_TANH_SMALL = float.fromhex("0x1.a36e2ep-12")
_TANH_CLAMP = float.fromhex("0x1.ffec88p+2")
_TANH_P = tuple(float.fromhex(h) for h in (
    "-0x1.3e4b8p-52", "0x1.c266fcp-43", "-0x1.7a6ffep-34", "0x1.b80082p-25",
    "0x1.f28694p-17", "0x1.4e1bdap-11", "0x1.40b3b8p-8"))
_TANH_Q = tuple(float.fromhex(h) for h in (
    "0x1.41a7b0p-20", "0x1.f12bacp-14", "0x1.29540ap-9", "0x1.40b3bap-8"))


@one_op
def tanh_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 tanh bitwise as XLA:CPU computes it under `jit`."""
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    p = torch.full_like(x2, _TANH_P[0])
    for coef in _TANH_P[1:]:
        p = fma_f32(x2, p, coef)
    q = torch.full_like(x2, _TANH_Q[0])
    for coef in _TANH_Q[1:]:
        q = fma_f32(x2, q, coef)
    y = (xc * p) / q
    y = torch.where(x.abs() < _TANH_SMALL, x, y)
    return torch.where(x.abs() >= 20.0, torch.copysign(torch.ones_like(x), x), y)


def _hexf(*hs):
    return tuple(float.fromhex(h) for h in hs)


# XLA:CPU's float32 log1p and exp (its elemental IR emitter, inline code
# with no libm call), read from the optimized LLVM IR and the object code
# of jit(jnp.log1p) and jit(jnp.exp2) (jax 0.9.0), where the backend
# contracts every multiply-add whose product has one use into an FMA.
# log1p: below |x| 0.41421357 a rational approximation, x + (x^3 P(x) /
# Q(x) - x^2/2), P and Q in Horner form with one FMA a step; above it
# log(1 + x) by `log_f32`: 1 + x split into a mantissa m in [0.5, 1) and
# an exponent, m < sqrt(1/2) folded to 2m, three interleaved quadratics
# joined by FMAs in x'^3, ln 2 as 0.693359375 - 2.12194440e-4.
_LOG1P_SPLIT = float.fromhex("0x1.a8279ap-2")
_LOG1P_P = _hexf("0x1.7bc096p-15", "0x1.fe818ap-2", "0x1.a509f4p+2", "0x1.de9738p+4",
                 "0x1.e798ecp+5", "0x1.c8e75ap+5", "0x1.40a202p+4")
_LOG1P_Q = _hexf("0x1.e2035ap+3", "0x1.4c30b6p+6", "0x1.bb865ap+7", "0x1.351946p+8",
                 "0x1.b0db14p+7", "0x1.e0f304p+5")
_LOG_A = _hexf("0x1.204376p-4", "-0x1.d7a37p-4", "0x1.de4a34p-4")
_LOG_B = _hexf("-0x1.fcba9ep-4", "0x1.23d37ep-3", "-0x1.555ca0p-3")
_LOG_C = _hexf("0x1.999d58p-3", "-0x1.fffff8p-3", "0x1.555554p-2")
_SQRT_HALF = float.fromhex("0x1.6a09e6p-1")
_LN2_HI = float.fromhex("0x1.63p-1")  # 0.693359375
_LN2_LO = float.fromhex("-0x1.bd0106p-13")  # -2.12194440e-4
_MIN_NORMAL = float.fromhex("0x1p-126")


def _horner(x, coefs, p):
    for c in coefs:
        p = fma_f32(p, x, c)
    return p


def _log_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log of y (y = 1 + x in log1p): exact specials, y <= 0
    or NaN gives NaN, 0 gives -inf, inf gives inf."""
    yc = torch.where(y > _MIN_NORMAL, y, _MIN_NORMAL)
    bits = yc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    lt = m < _SQRT_HALF
    xm = (m - 1.0) + torch.where(lt, m, 0.0)
    e = e - torch.where(lt, 1.0, 0.0)
    z = xm * xm
    x3 = z * xm
    p1, p2, p3 = (_horner(xm, c[1:], c[0] * torch.ones_like(xm)) for c in (_LOG_A, _LOG_B, _LOG_C))
    q = fma_f32(fma_f32(p1, x3, p2), x3, p3)
    r = fma_f32(q, x3, e * _LN2_LO)
    r = fma_f32(z, -0.5, xm) + r
    r = fma_f32(e, _LN2_HI, r)
    r = torch.where((y <= 0) | torch.isnan(y), math.nan, r)
    r = torch.where(y == 0, -math.inf, r)
    return torch.where(y == math.inf, math.inf, r)


@one_op
def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p bitwise as XLA:CPU computes it under `jit`."""
    x2 = x * x
    q = _horner(x, _LOG1P_Q[1:], x + _LOG1P_Q[0])  # the first step is fma(1, x, c)
    p = _horner(x, _LOG1P_P[1:], _LOG1P_P[0] * torch.ones_like(x))
    small = x + fma_f32(x2, -0.5, (x * x2) * (p / q))
    return torch.where(x.abs() < _LOG1P_SPLIT, small, _log_f32(x + 1.0))


# exp: x clamped to [-87.8, 88.8], n = floor(fma(x, log2 e, 0.5)) clamped
# to [-127, 127], r = x - n ln 2 in two FMAs, e^r = 1 + fma(P(r), r^2, r)
# (P Horner from r^4's coefficient to 1/2), times 2^n made from its bits.
# `jnp.exp2(x)` compiles to exp(x * 0.6931472): not exact at integers.
_EXP_LO, _EXP_HI = float.fromhex("-0x1.5f3334p+6"), float.fromhex("0x1.633334p+6")
_LOG2E = float.fromhex("0x1.715476p+0")
_EXP_P = _hexf("0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.111210p-7", "0x1.555382p-5",
               "0x1.555554p-3", "0x1p-1")
_LN2_F32 = float.fromhex("0x1.62e430p-1")


@one_op
def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 exp bitwise as XLA:CPU computes it under `jit` (finite x;
    below -87.8 the result is flushed, as XLA's 2^-127 is 0)."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma_f32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma_f32(-n, _LN2_HI, x)
    r = fma_f32(-n, _LN2_LO, r)
    p = _horner(r, _EXP_P[1:], _EXP_P[0] * torch.ones_like(r))
    y = fma_f32(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale


@one_op
def exp2_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 `jnp.exp2` under `jit`: exp(x * 0.6931472)."""
    return exp_xla(x * _LN2_F32)


# XLA's float32 ErfInv (M. Giles' single-precision approximation, as
# XLA's math library builds it): w = -log1p(-x*x); below 5 a degree-8
# polynomial in w - 2.5, else one in sqrt(w) - 3; Horner steps
# `c + p * w`, which XLA:CPU contracts into one FMA each.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded as XLA's `jnp.sqrt` and numpy's
    are: the float64 root rounded once, which is exact for a float32
    input (53 >= 2 * 24 + 2 bits). torch's float32 sqrt on the CPU is an
    ulp off on about 0.7% of inputs."""
    return torch.sqrt(x.double()).float()


@one_op
def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv bitwise as XLA:CPU computes it under `jit`: its
    polynomial and rounding points over its own `log1p` (`log1p_xla`;
    `torch.log1p` differs on about 8% of the inputs here, `torch.erfinv`,
    another function, on about 33% of uniform draws). sqrt(w) is
    correctly rounded (`sqrt_rn`), as XLA's is."""
    w = -log1p_xla(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)

    def coef(i):  # Python floats: filled on the device, no copy from the host
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]).to(torch.float32)

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma_f32(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


# glibc's float32 sinf/cosf (sysdeps/ieee754/flt-32 s_sinf.c, s_cosf.c,
# sincosf.h; the x86-64 FMA build, whose multiply-adds are single-rounded),
# constants read from libm's .rodata: pi/2 and its inverse scaled by 2**24,
# the cosine and sine polynomials of __sincosf_table[0] (table 1 is its
# cosine negated), pi * 2**-62, and 4/pi in 32-bit words (__inv_pio4).
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
_HPI_HI = float.fromhex("0x1.921fb58p+0")  # _HPI's first 26 bits, and the rest:
_HPI_LO = float.fromhex("-0x1.dde974p-27")  # n * each is exact for |n| < 2**7
_COS_C = tuple(float.fromhex(h) for h in (
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
    "0x1.99343027bf8c3p-16"))
_SIN_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
_PI63 = float.fromhex("0x1.921fb54442d18p-62")
INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
    0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd,
    0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43,
    0x993c4390, 0x3c439041)
_M32 = 0xFFFFFFFF


_TABLES: dict = {}  # device -> INV_PIO4 as an int64 tensor


def _inv_pio4(device) -> torch.Tensor:
    """INV_PIO4 on `device`, filled there from Python scalars (no copy
    from the host, so no synchronisation inside a decode loop) once per
    device."""
    table = _TABLES.get(device)
    if table is None:
        table = _TABLES[device] = torch.stack(
            [torch.full((), w, dtype=torch.int64, device=device) for w in INV_PIO4])
    return table


def _reduce_large(xi: torch.Tensor):
    """glibc's reduce_large: the float with bits xi (>= 2**7 in size) mod
    pi/2 from 4/pi's bits in 32x32 -> 64-bit products, carried here as
    32-bit halves so no int64 operation overflows. Returns the quadrant n
    and the remainder as a float64 tensor."""
    table = _inv_pio4(xi.device)
    i = (xi >> 26) & 15
    m = ((xi & 0x7FFFFF) | 0x800000) << ((xi >> 23) & 7)  # < 2**31
    # torch.take, not table[i]: a 0-d index tensor would be read on the host
    r0 = (m * torch.take(table, i)) & _M32  # the low word of a 32-bit product
    r1 = m * torch.take(table, i + 4)  # < 2**63
    r2 = m * torch.take(table, i + 8)
    lo = (r2 >> 32) + (r1 & _M32)
    hi = (r0 + (r1 >> 32) + (lo >> 32)) & _M32  # res0 = hi:lo mod 2**64
    lo = lo & _M32
    n = ((hi + (1 << 29)) & _M32) >> 30  # (res0 + 2**61) >> 62
    hi = (hi - (n << 30)) & _M32
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)  # res0 as int64, high word
    v = hi.double() * 4294967296.0 + lo.double()  # one rounding, as cvtsi2sd
    return n, v * _PI63


@one_op
def sincos_glibc(x: torch.Tensor):
    """float32 x -> (sinf(x), cosf(x)) bitwise as glibc 2.36's x86-64 FMA
    build computes them (and so as XLA:CPU's jitted sin/cos, which call
    it): below |x| = 120 the reduction by pi/2 in double, from 120 the
    reduction against 4/pi's bits, then the double polynomials rounded
    once to float. Non-finite x gives NaN."""
    xi = x.view(torch.int32).to(torch.int64) & _M32
    top = (xi >> 20) & 0x7FF
    xd = x.double()
    small = top < 0x3F4  # |x| < pi/4: no reduction
    fast = ~small & (top < 0x42F)  # |x| < 120
    # reduce_fast: n = round(x * 2/pi) from the 2**24-scaled product, and
    # x - n*pi/2 with one rounding (the FMA), exact from the split of pi/2
    t = (torch.where(fast, xd, 0.0) * _HPI_INV).to(torch.int64)
    nf = (t + 0x800000) >> 24
    nfd = nf.double()
    rf = (xd - nfd * _HPI_HI) - nfd * _HPI_LO
    nl, rl = _reduce_large(xi)
    sign = xi >> 31
    zero = torch.zeros_like(nf)
    n = torch.where(small, zero, torch.where(fast, nf, nl))  # picks the polynomial
    q = torch.where(small, zero, torch.where(fast, nf, nl + sign))  # picks the signs
    r = torch.where(small, xd, torch.where(fast, rf, rl))
    xs = torch.where((q & 3 == 1) | (q & 3 == 2), -r, r)
    x2 = r * r
    x3 = x2 * xs
    s = fma_f64(fma_f64(x2, _SIN_S[2], _SIN_S[1]), x2 * x3, fma_f64(x3, _SIN_S[0], xs))
    x4 = x2 * x2
    c0, c1, c2, c3, c4 = _COS_C
    c = fma_f64(fma_f64(x2, c4, c3), x2 * x4, fma_f64(x4, c2, fma_f64(x2, c1, c0)))
    c = torch.where(q & 2 == 2, -c, c)
    odd = n & 1 == 1
    sin, cos = torch.where(odd, c, s).float(), torch.where(odd, s, c).float()
    tiny = top < 0x398  # |x| < 2**-12: sin x = x, cos x = 1
    sin = torch.where(tiny, x, sin)
    cos = torch.where(tiny, torch.ones_like(x), cos)
    bad = top >= 0x7F8
    return sin.masked_fill(bad, math.nan), cos.masked_fill(bad, math.nan)


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


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x) over its last two axes [..., T, K] in XLA:CPU's order (read
    from the compiled HLO of `jnp.sum` over a [T, ...] array, the K axes
    flattened in row order): while more than SUM_BLOCK rows remain, a
    `reduce-window` of SUM_BLOCK rows with the zero pad split lo = pad //
    2 before and the rest after, each window summed element by element
    in row order (rows, then K); then the remaining windows' sums in
    order. Elementwise float32 adds, so the result is the same on every
    device (`network.transfer.column_sum` is the K = 1, per-column
    case; the telemetry totals are the T-only case)."""
    while x.shape[-2] > SUM_BLOCK:
        pad = -x.shape[-2] % SUM_BLOCK
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
        blocks = x.reshape(x.shape[:-2] + (-1, SUM_BLOCK * x.shape[-1]))
        acc = blocks[..., 0]
        for i in range(1, blocks.shape[-1]):
            acc = acc + blocks[..., i]
        x = acc[..., None]
    flat = x.reshape(x.shape[:-2] + (-1,))
    acc = flat[..., 0]
    for i in range(1, flat.shape[-1]):
        acc = acc + flat[..., i]
    return acc


# ---------------------------------------------------------------------------
# XLA:CPU's order for jnp.sum over the last one or two axes of [..., R, C]
# (all of them, or R alone: a column sum), as jax 0.9.0 compiles it on
# x86-64, read from the HLO and the optimized LLVM IR of the simulators'
# scan bodies (ROADMAP hazard 34):
# * while an axis being summed is longer than SUM_BLOCK, a reduce-window of
#   SUM_BLOCK along each such axis (an axis of n <= SUM_BLOCK is taken
#   whole) with the zero pad split lo = pad // 2, then the same again on
#   its output; a last reduce over what is left;
# * XLA marks the adds of a reduction `reassoc`, so LLVM's loop vectorizer
#   may split a loop over rows into lanes: a slab of whole rows (width <=
#   SUM_BLOCK, no pad before it) of `rows` rows of `width` 2..8 values
#   keeps `_row_lanes(rows, width)` running sums, row r in lane r % lanes,
#   each row's values added in order, the lanes then added pairwise
#   (lane i + lane i + lanes/2, halving) and the rows the lanes left over
#   added one by one; a window padded by one row after its rows (lo 0,
#   hi 1) vectorizes its first rows - 1 rows so;
# * a window padded by one column after (lo 0, hi 1) adds the first
#   width - 1 values of each row, then the last value of each row;
# * everything else (and every column sum) adds row by row in order.
# Each accumulator starts at +0.0 (the reduce's init; the split lanes but
# the first at -0.0), so a padded zero never changes a sum's bits.


def _row_lanes(rows: int, width: int) -> int:
    """The running sums LLVM splits a loop over `rows` whole rows of
    `width` values into (1: not split), read off the compiled code of
    every rows, width <= SUM_BLOCK."""
    if not 2 <= width <= 8:
        return 1
    if rows in (2, 4, 8):
        return rows
    if 16 <= rows <= 19 or 24 <= rows <= 27 or rows == 32:
        return 8 if width <= 6 else 4
    if 20 <= rows <= 23:
        return 4
    if 28 <= rows <= 31:
        return 8 if width == 2 else 4
    return 1


class SumLevel(NamedTuple):
    """One pass of a `sum_plan`: the [rows, cols] slab of a lane in
    windows of w0 x w1 (lo0, lo1 zeros before), o0 x o1 outputs; the
    first `nvec` rows of a window in `lanes` running sums; `last_col`:
    each row's last value added after all the others."""

    rows: int
    cols: int
    w0: int
    w1: int
    lo0: int
    lo1: int
    o0: int
    o1: int
    lanes: int
    nvec: int
    last_col: bool


class SumPlan(NamedTuple):
    """The passes of one sum; the last is one window over what is left
    (o0 = 1; o1 = 1, or cols when `by_column`)."""

    levels: tuple
    by_column: bool


def sum_plan(rows: int, cols: int, by_column: bool = False) -> SumPlan:
    """XLA:CPU's sum over a lane's [rows, cols] (1-D: cols = 1), or over
    its rows alone per column (`by_column`)."""
    levels = []
    n0, n1 = rows, cols
    while True:
        last = n0 <= SUM_BLOCK and (by_column or n1 <= SUM_BLOCK)
        w0 = min(n0, SUM_BLOCK)
        w1 = 1 if by_column else min(n1, SUM_BLOCK)
        p0, p1 = -n0 % w0, -n1 % w1
        lo0, lo1 = p0 // 2, p1 // 2
        whole = not by_column and w1 == n1  # windows of whole rows
        lanes, nvec = 1, 0
        if whole and p0 == 0:
            lanes, nvec = _row_lanes(w0, w1), w0
        elif whole and (lo0, p0) == (0, 1):
            lanes, nvec = _row_lanes(w0 - 1, w1), w0 - 1
        if lanes == 1:
            nvec = 0
        o0, o1 = (n0 + p0) // w0, (n1 + p1) // w1
        levels.append(SumLevel(n0, n1, w0, w1, lo0, lo1, o0, o1, lanes, nvec,
                               not by_column and (lo1, p1) == (0, 1)))
        if last:
            return SumPlan(tuple(levels), by_column)
        n0, n1 = o0, o1


def _plan_level(x: torch.Tensor, v: SumLevel) -> torch.Tensor:
    """One pass over x [..., rows, cols] -> [..., o0, o1]."""
    p0, p1 = v.o0 * v.w0 - v.rows, v.o1 * v.w1 - v.cols
    if p0 or p1:
        x = F.pad(x, (v.lo1, p1 - v.lo1, v.lo0, p0 - v.lo0))
    b = x.reshape(x.shape[:-2] + (v.o0, v.w0, v.o1, v.w1))

    def at(r, c):
        return b[..., :, r, :, c]

    acc = torch.zeros(b.shape[:-4] + (v.o0, v.o1), dtype=x.dtype, device=x.device)
    first = 0
    if v.last_col:
        for r in range(v.w0):
            for c in range(v.w1 - 1):
                acc = acc + at(r, c)
        for r in range(v.w0):
            acc = acc + at(r, v.w1 - 1)
        return acc
    if v.lanes > 1:
        lanes = [acc] + [torch.full_like(acc, -0.0) for _ in range(v.lanes - 1)]
        first = v.nvec // v.lanes * v.lanes
        for r in range(first):
            for c in range(v.w1):
                lanes[r % v.lanes] = lanes[r % v.lanes] + at(r, c)
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [lanes[i] + lanes[i + h] for i in range(h)]
        acc = lanes[0]
    for r in range(first, v.w0):
        for c in range(v.w1):
            acc = acc + at(r, c)
    return acc


def plan_sum(x: torch.Tensor, plan: SumPlan) -> torch.Tensor:
    """x [..., rows, cols] summed by `plan` -> [...] or, by column,
    [..., cols]: elementwise float32 adds, the same bits on every
    device."""
    for v in plan.levels:
        x = _plan_level(x, v)
    return x[..., 0, :] if plan.by_column else x[..., 0, 0]
