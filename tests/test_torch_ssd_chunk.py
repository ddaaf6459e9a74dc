"""The port's Mamba-2 SSD intra-chunk step and chunked scan against the
JAX package.

Tolerance: |err| <= 2e-5 + 2e-5 * |want| (tests/test_kernels.py's f32),
except `cumsum_xla`, which is bitwise equal to `jit(jnp.cumsum)`, and the
port's own two-halves-vs-one-pass check, at tests/test_consistency.py's
1e-4 for the same property of the JAX function.

Decays: "strong" is tests/test_kernels.py's a = -softplus(N(0,1));
"weak" a = -0.01 softplus(N(0,1)), where the whole causal triangle and
the chunk state from position 0 carry weight; "init" a = dt * A with the
repo's Mamba-2 init, A = -U(1,16) and dt = softplus(N(0,1)), where |ci|
reaches thousands within a 256-long chunk. The l = 256 "init" case is
the one that fails with `torch.cumsum` in place of `cumsum_xla`
(`test_torch_cumsum_would_miss_at_l256`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402
from repro_torch.kernels.numerics import cumsum_xla  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _decays(rng, shape, kind):
    sp = np.log1p(np.exp(rng.standard_normal(shape))).astype(np.float32)
    if kind == "strong":
        return -sp
    if kind == "weak":
        return (np.float32(-0.01) * sp).astype(np.float32)
    A = -rng.uniform(1, 16, shape[-1]).astype(np.float32)  # "init"
    return (sp * A).astype(np.float32)


def _chunk_inputs(B, nc, l, H, P, N, kind, seed=0):
    rng = np.random.default_rng(seed)
    a = _decays(rng, (B, nc, l, H), kind)
    x = rng.standard_normal((B, nc, l, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, nc, l, N)).astype(np.float32)
    Cm = rng.standard_normal((B, nc, l, N)).astype(np.float32)
    return a, x, Bm, Cm


@pytest.mark.parametrize("L", [1, 5, 8, 16, 17, 21, 32, 100, 256, 512])
def test_cumsum_xla_is_bitwise_jit_cumsum(L):
    a = _decays(np.random.default_rng(L), (2, 3, L, 4), "init")
    for axis in (2, -1):
        want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=axis))(a))
        got = cumsum_xla(torch.from_numpy(a), dim=axis).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=f"axis {axis}")


def test_torch_cumsum_is_not_xla_order_at_256():
    a = _decays(np.random.default_rng(0), (2, 3, 256, 4), "init")
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=2))(a))
    assert not np.array_equal(torch.cumsum(torch.from_numpy(a), dim=2).numpy(), want)


SWEEP = [  # tests/test_kernels.py's shapes (B, nc, l, H, P, N, block_heads), plus l = 256
    (1, 2, 16, 8, 8, 16, 8),
    (2, 3, 32, 16, 8, 16, 8),
    (1, 1, 64, 4, 16, 32, 4),
    (2, 2, 32, 16, 16, 8, 16),
    (1, 2, 256, 4, 16, 32, 4),
]


@pytest.mark.parametrize("kind", ["strong", "weak", "init"])
@pytest.mark.parametrize("B,nc,l,H,P,N,bh", SWEEP)
def test_plain_matches_ref_and_pallas(B, nc, l, H, P, N, bh, kind):
    a, x, Bm, Cm = _chunk_inputs(B, nc, l, H, P, N, kind)
    ref = jax.jit(jref.ssd_chunk_intra_ref)(a, x, Bm, Cm)
    pallas = jops.ssd_chunk_intra(a, x, Bm, Cm, block_heads=bh, interpret=True)
    got = ops.ssd_chunk_intra(*map(torch.from_numpy, (a, x, Bm, Cm)))
    for g, r, p, name in zip(got, ref, pallas, ("y_diag", "S_c", "total")):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"{name} vs ref", **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), err_msg=f"{name} vs Pallas", **TOL)


def test_torch_cumsum_would_miss_at_l256(monkeypatch):
    """The hazard is real: with torch.cumsum's order the init's decays
    move y_diag past the tolerance at l = 256."""
    a, x, Bm, Cm = _chunk_inputs(1, 2, 256, 4, 16, 32, "init")
    ref = np.asarray(jax.jit(jref.ssd_chunk_intra_ref)(a, x, Bm, Cm)[0])
    monkeypatch.setattr(ssd_chunk, "cumsum_xla", lambda t, dim: torch.cumsum(t, dim))
    got = ssd_chunk.ssd_chunk_intra_plain(*map(torch.from_numpy, (a, x, Bm, Cm)))[0].numpy()
    assert not np.all(np.abs(got - ref) <= 2e-5 + 2e-5 * np.abs(ref))


def _scan_inputs(B, S, H, P, N, kind, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    if kind == "init":
        A = -rng.uniform(1, 16, H).astype(np.float32)
    else:
        A = -np.exp(rng.standard_normal(H)).astype(np.float32) * (0.01 if kind == "weak" else 1)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return x, dt, A.astype(np.float32), Bm, Cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S,chunk,kind", [
    (64, 16, "strong"),   # a multiple of the chunk
    (50, 16, "weak"),     # ragged: padded with dt = 0
    (10, 16, "strong"),   # shorter than the chunk
    (300, 256, "init"),   # the full config's chunk, ragged
    (256, 256, "weak"),
])
def test_ssd_chunked_matches_jax(S, chunk, kind, with_h0):
    x, dt, A, Bm, Cm, h0 = _scan_inputs(2, S, 3, 8, 16, kind)
    h0 = h0 if with_h0 else None
    want_y, want_h = jax.jit(jmamba2.ssd_chunked, static_argnums=5)(x, dt, A, Bm, Cm, chunk, h0)
    got_y, got_h = mamba2.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk,
                                      h0=None if h0 is None else torch.from_numpy(h0))
    assert got_y.shape == (2, S, 3, 8) and got_h.shape == (2, 3, 16, 8)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), err_msg="y", **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), err_msg="state", **TOL)


def test_ssd_chunked_two_halves_with_carried_state_equal_one_pass():
    x, dt, A, Bm, Cm, _ = _scan_inputs(1, 40, 2, 4, 8, "strong")
    t = [torch.from_numpy(v) for v in (x, dt, A, Bm, Cm)]
    y_full, h_full = mamba2.ssd_chunked(*t, 8)
    first = [v[:, :24] if v.dim() > 1 else v for v in t]
    second = [v[:, 24:] if v.dim() > 1 else v for v in t]
    y1, h1 = mamba2.ssd_chunked(*first, 8)
    y2, h2 = mamba2.ssd_chunked(*second, 8, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=1e-4, atol=1e-4)
    want_y, _ = jax.jit(jmamba2.ssd_chunked, static_argnums=5)(x, dt, A, Bm, Cm, 8)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4)


def test_cuda_wrapper_checks_its_inputs_before_building():
    a, x, Bm, Cm = (torch.from_numpy(v) for v in _chunk_inputs(1, 1, 16, 2, 8, 8, "strong"))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk.ssd_chunk_intra_cuda(a, x, Bm, Cm)
    with pytest.raises(ValueError, match="float32"):
        ssd_chunk.ssd_chunk_intra_cuda(a.double(), x, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk.ssd_chunk_intra_cuda(a, x, Bm.transpose(2, 3).contiguous().transpose(2, 3), Cm)
    with pytest.raises(ValueError, match="Cm"):
        ssd_chunk.ssd_chunk_intra_cuda(a, x, Bm, Cm[..., :4])
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_chunk_intra(a.to("meta"), x.to("meta"), Bm.to("meta"), Cm.to("meta"))
    assert ssd_chunk.launches == 0


# ---- a tensor-core route's arithmetic, emulated on the CPU --------------
# The kernel (csrc/ssd_chunk.cu) sums on the float32 CUDA cores in the
# plain version's order, because the float32 model needs its bits (its
# source note). On the tensor cores the products would run in TF32, as the
# backward's kernel runs them (csrc/ssd_chunk_bwd.cu): each float32
# operand split into hi and lo, a product accumulating lo.hi + hi.lo +
# hi.hi one k8 step at a time, each instruction's 8 products and the
# accumulator summed exactly and rounded once to float32 toward zero
# (`ssd_chunk.tf32_split`, `tc_step`, `tc_steps`, shared with the
# backward's emulation). The emulation follows that order of splits and
# steps and holds the result to chip_smoke 3d's bound: |err| <= SSD_TOL *
# max(1, sum|terms|) + SSD_TOL * |plain|. It shows which of the two routes
# 3d's contract would admit.
SSD_TOL = 2e-5


def _tensor_core_emulation(a, x, Bm, Cm, terms):
    """(y_diag, S_c) of the tensor-core route for one batch row: the
    scores with hi.hi and the small terms in two accumulators each, by the
    parity of the k8 step, then (hi.hi) + (small); the weights
    G * exp(ci_i - ci_j) in float32, 0 above the diagonal; y and S_c over
    the positions j, the k order inside a step being irrelevant to an
    exact step sum."""
    a, x, Bm, Cm = (torch.from_numpy(v) for v in (a, x, Bm, Cm))
    _, nc, l, H = a.shape
    ci = cumsum_xla(a, dim=2)
    y = torch.zeros(x.shape)
    S_c = torch.zeros((1, nc, H, Bm.shape[-1], x.shape[-1]))
    tril = torch.ones((l, l), dtype=torch.bool).tril()
    for c in range(nc):
        C, B = Cm[0, c], Bm[0, c]
        parts = []
        for par in (0, 1):
            big, small = torch.zeros((l, l)), torch.zeros((l, l))
            for k in range(8 * par, C.shape[1], 16):
                (cb, cs), (bb, bs) = ssd_chunk.tf32_split(C[:, k:k + 8]), ssd_chunk.tf32_split(
                    B[:, k:k + 8])
                if terms == 3:
                    small = ssd_chunk.tc_step(small, cs, bb.T)
                    small = ssd_chunk.tc_step(small, cb, bs.T)
                big = ssd_chunk.tc_step(big, cb, bb.T)
            parts.append((big, small))
        G = (parts[0][0] + parts[1][0]) + (parts[0][1] + parts[1][1])
        last = ci[0, c, -1]
        for h in range(H):
            cih = ci[0, c, :, h]
            diff = torch.where(tril, cih[:, None] - cih[None, :], 0.0)  # 0 above: no overflow
            W = torch.where(tril, G * torch.exp(diff), 0.0)
            y[0, c, :, h] = ssd_chunk.tc_steps(torch.zeros((l, x.shape[-1])), W, x[0, c, :, h],
                                               terms)
            xd = x[0, c, :, h] * torch.exp(last[h] - cih)[:, None]
            S_c[0, c, h] = ssd_chunk.tc_steps(torch.zeros(S_c.shape[-2:]), B.T, xd, terms)
    return y.numpy(), S_c.numpy()


def _worst_over_tolerance(kind, terms):
    """Largest |err| / bound of the emulation against the plain version
    at one batch row of mamba2-1.3B's chunk (l 256, N 128, P 64), 8 heads."""
    a, x, Bm, Cm = _chunk_inputs(1, 2, 256, 8, 64, 128, kind)
    t = [torch.from_numpy(v) for v in (a, x, Bm, Cm)]
    want = ssd_chunk.ssd_chunk_intra_plain(*t)
    sum_abs = ssd_chunk.ssd_chunk_intra_plain(t[0], t[1].abs(), t[2].abs(), t[3].abs())
    got = _tensor_core_emulation(a, x, Bm, Cm, terms)
    worst = 0.0
    for g, w, s in zip(got, want, sum_abs):
        w, s = w.numpy(), s.numpy()
        bound = SSD_TOL * np.maximum(s, 1.0) + SSD_TOL * np.abs(w)
        worst = max(worst, float((np.abs(g - w) / bound).max()))
    return worst


@pytest.mark.parametrize("kind", ["strong", "weak", "init"])
def test_single_tf32_would_miss(kind):
    """One TF32 product (operands rounded to 10 mantissa bits) falls
    outside 3d's float32 bound: the split is needed."""
    assert _worst_over_tolerance(kind, terms=1) > 1.0


@pytest.mark.parametrize("kind", ["strong", "weak", "init"])
def test_three_tf32_keeps_the_tolerance(kind):
    """3xTF32 stays well inside 3d's bound (with a 10x margin for the
    card's own accumulation order); it is phase 9's float32 gate, not 3d,
    that needs the plain version's bits (ROADMAP hazard 17)."""
    assert _worst_over_tolerance(kind, terms=3) <= 0.1
