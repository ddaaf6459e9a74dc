"""The port's score pass against the JAX reference, bitwise.

`repro_torch.kernels.carbon_score.carbon_scores_plain` (what the port
runs on the CPU, and what the CUDA kernel is held against on the card)
must equal `jax.jit(carbon_scores_ref)` and the interpret-mode Pallas
kernel bit for bit: under jit XLA:CPU computes c = fmaf(VCc, pc, -Qc)
and b = fmaf(V*Ce, pe, qmin) - Qe, each rounded once. The FMA emulation
is also held against an exact rational oracle on crafted midpoint cases,
where a plain float64 emulation rounds twice and is wrong.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import carbon_scores_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.numerics import fma_f32  # noqa: E402

f32 = np.float32
_ref_jit = jax.jit(carbon_scores_ref)


def round_f32(x: Fraction) -> np.float32:
    """Correctly rounded float32 (nearest, ties to even) of a rational."""
    approx = f32(float(x))
    cands = [np.nextafter(approx, f32(-np.inf)), approx, np.nextafter(approx, f32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(c.view(np.uint32)) & 1))


def _inputs(rng, M, N):
    return (
        rng.integers(0, 5000, (M, N)).astype(f32),
        rng.uniform(1, 100, (M, N)).astype(f32),
        rng.integers(0, 5000, M).astype(f32),
        rng.uniform(1, 10, M).astype(f32),
        (f32(0.05) * rng.uniform(0, 700, N).astype(f32)).astype(f32),
        f32(f32(0.05) * f32(350.0)),
    )


def _port(Qc, pc, Qe, pe, VCc, VCe):
    return ops.carbon_scores(*(torch.from_numpy(np.asarray(x)) for x in (Qc, pc, Qe, pe, VCc)),
                             torch.tensor(VCe))


def _assert_bitwise(port, ref):
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype


# the shapes of tests/test_kernels.py::test_carbon_scores_sweep
@pytest.mark.parametrize(
    "M,N,bm,bn",
    [
        (256, 256, 128, 128),
        (512, 1024, 256, 256),
        (128, 128, 128, 128),
        (1024, 256, 256, 64),
        (100, 37, 64, 16),
        (257, 129, 128, 128),
        (5, 5, 256, 256),
        (300, 200, 128, 128),
    ],
)
def test_plain_bitwise_vs_jit_reference_and_interpret_kernel(M, N, bm, bn):
    args = _inputs(np.random.default_rng(M * 7 + N), M, N)
    port = _port(*args)
    _assert_bitwise(port, _ref_jit(*args))
    jargs = [jnp.asarray(x) for x in args]
    _assert_bitwise(port, jops.carbon_scores(*jargs, block_m=bm, block_n=bn, interpret=True))


def test_plain_is_fused_where_the_reference_is():
    """The unfused forms differ from the reference on random inputs (so
    the bitwise test above does test the rounding)."""
    Qc, pc, Qe, pe, VCc, VCe = _inputs(np.random.default_rng(1), 256, 256)
    c_ref, _, b_ref = (np.asarray(x) for x in _ref_jit(Qc, pc, Qe, pe, VCc, VCe))
    assert np.any(VCc[None, :] * pc - Qc != c_ref)
    c, _, b = _port(Qc, pc, Qe, pe, VCc, VCe)
    np.testing.assert_array_equal(c.numpy(), c_ref)
    np.testing.assert_array_equal(b.numpy(), b_ref)


@pytest.mark.parametrize("M,N", [(64, 16), (257, 129), (5, 5)])
def test_argmin_ties_go_to_the_first_index(M, N):
    rng = np.random.default_rng(M + N)
    Qc, pc, Qe, pe, VCc, VCe = _inputs(rng, M, N)
    Qc = rng.integers(0, 3, (M, N)).astype(f32)  # many ties in every row
    Qc[0] = 7.0  # a row that is one long tie
    _, n1, _ = _port(Qc, pc, Qe, pe, VCc, VCe)
    np.testing.assert_array_equal(n1.numpy(), np.argmin(Qc, axis=1).astype(np.int32))
    np.testing.assert_array_equal(n1.numpy(), np.asarray(_ref_jit(Qc, pc, Qe, pe, VCc, VCe)[1]))
    assert n1[0] == 0


# a*b + c lands a hair off an float32 midpoint: float64 rounds it onto
# the midpoint, and ties-to-even then picks the wrong float32
_A = f32(1 + 2.0**-23)
_B = f32(2.0**-24 * (1 - 2.0**-23))
_C = f32(1 + 2.0**-23)


def test_fma_midpoint_single_rounding():
    exact = Fraction(float(_A)) * Fraction(float(_B)) + Fraction(float(_C))
    want = round_f32(exact)
    naive = f32(np.float64(_A) * np.float64(_B) + np.float64(_C))
    assert naive != want  # the crafted case does defeat double rounding
    got = fma_f32(torch.tensor(_A), torch.tensor(_B), torch.tensor(_C))
    assert got.item() == want
    neg = fma_f32(torch.tensor(-_A), torch.tensor(_B), torch.tensor(-_C))
    assert neg.item() == round_f32(-exact)


def test_score_pass_midpoint_matches_exact_and_jit_reference():
    """c and b both hit a midpoint case; the plain version, the jitted
    reference (hardware FMA) and the exact oracle agree."""
    Qc = np.array([[-_C]], f32)
    pc = np.array([[_B]], f32)
    Qe = np.array([0.0], f32)
    pe = np.array([_B], f32)
    VCc = np.array([_A], f32)
    c, n1, b = _port(Qc, pc, Qe, pe, VCc, _A)
    exact = Fraction(float(_A)) * Fraction(float(_B))
    assert c.item() == round_f32(exact + Fraction(float(_C)))
    assert b.item() == round_f32(exact - Fraction(float(_C)))
    _assert_bitwise((c, n1, b), _ref_jit(Qc, pc, Qe, pe, VCc, _A))


def test_fma_f32_random_against_exact_oracle():
    rng = np.random.default_rng(3)
    n = 400
    a = rng.uniform(-4, 4, n).astype(f32)
    b = rng.uniform(-4, 4, n).astype(f32)
    c = rng.uniform(-100, 100, n).astype(f32)
    # half the cases: c chosen so a*b + c sits next to a float32 midpoint
    c[::2] = (-(a[::2].astype(np.float64) * b[::2]) + 1.0 + 2.0**-24).astype(f32)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], f32)
    np.testing.assert_array_equal(got, want)
