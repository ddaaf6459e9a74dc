"""The SSD step's backward on the tensor cores, its arithmetic emulated
on the CPU.

`csrc/ssd_chunk_bwd.cu` runs its products (G, U, R, the dy term of dx,
dC, dB's two terms) on the tensor cores in 3xTF32: each float32 operand
split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna.tf32.f32), a
product accumulating lo.hi, hi.lo and hi.hi one k8 step at a time, each
instruction's sum rounded to float32 toward zero.
`ssd_chunk.ssd_chunk_intra_bwd_tc` repeats those steps in the kernel's
accumulators and order (`tc_steps`, shared with the forward's emulation
in tests/test_torch_ssd_chunk.py; `terms=1`: one TF32 product, hi.hi
alone). Held to chip_smoke 3d's bound, |err| <= SSD_TOL * max(1,
sum|terms|) + SSD_TOL * |plain| (`ssd_chunk_intra_bwd_terms`), against
the plain backward: 3xTF32 within a tenth of it at 3d's CPU-sized edges
under the three decays and at the training widths (8 heads, and 3d's 64
with B = nc = 1); one TF32 product beyond it. Truncation moves an
accumulator the same way at every step, so its error grows with the
steps it takes in a row: dB's e x dS term takes each head in an
accumulator of its own. dG's order (a fused multiply-add a head inside
each group of HEAD_GROUP heads, the groups' partials added in group
order) within the same bound of the plain dG.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers

from repro_torch.kernels import ssd_chunk  # noqa: E402
from repro_torch.kernels.numerics import cumsum_xla  # noqa: E402

SSD_TOL = 2e-5  # chip_smoke.py's SSD_TOL


def _decays(rng, shape, kind):
    sp = np.log1p(np.exp(rng.standard_normal(shape))).astype(np.float32)
    if kind == "strong":
        return -sp
    if kind == "weak":
        return (np.float32(-0.01) * sp).astype(np.float32)
    A = -rng.uniform(1, 16, shape[-1]).astype(np.float32)  # "init"
    return (sp * A).astype(np.float32)


def _inputs(B, nc, l, H, P, N, kind, zero="", seed=0):
    rng = np.random.default_rng(seed)
    a = _decays(rng, (B, nc, l, H), kind)
    x, dy = (rng.standard_normal((B, nc, l, H, P)).astype(np.float32) for _ in range(2))
    Bm, Cm = (rng.standard_normal((B, nc, l, N)).astype(np.float32) for _ in range(2))
    dS = rng.standard_normal((B, nc, H, N, P)).astype(np.float32)
    dtot = rng.standard_normal((B, nc, H)).astype(np.float32)
    if zero == "dy":
        dy[:] = 0
    elif zero == "dS":
        dS[:], dtot[:] = 0, 0
    return [torch.from_numpy(v) for v in (a, x, Bm, Cm, dy, dS, dtot)]


def _worst(args, terms):
    """Largest |err| / bound over the four outputs of the emulation."""
    want = ssd_chunk.ssd_chunk_intra_bwd_plain(*args)
    sums = ssd_chunk.ssd_chunk_intra_bwd_terms(*args)
    got = ssd_chunk.ssd_chunk_intra_bwd_tc(*args, terms=terms)
    worst = 0.0
    for g, w, s in zip(got, want, sums):
        assert g.dtype == torch.float32 and g.shape == w.shape and torch.isfinite(g).all()
        bound = SSD_TOL * s.clamp_min(1.0) + SSD_TOL * w.abs()
        worst = max(worst, float(((g - w).abs() / bound).max()))
    return worst


EDGES = [  # B, nc, l, H, P, N, zero: chip_smoke 3d's CPU-sized edges
    (2, 3, 1, 5, 16, 16, ""),      # l 1
    (2, 3, 16, 5, 16, 16, ""),     # l 16, P 16, N 16
    (2, 3, 17, 5, 16, 16, ""),     # l 17: a ragged tile and scan block
    (1, 2, 65, 9, 64, 128, "dS"),  # a zero dS (and dtot); H 9: a second head group of one
    (1, 2, 65, 9, 64, 128, "dy"),  # a zero dy
    (1, 1, 100, 7, 33, 40, ""),    # ragged everything
]


@pytest.mark.parametrize("kind", ["init", "strong", "weak"])
@pytest.mark.parametrize("B,nc,l,H,P,N,zero", EDGES)
def test_three_tf32_holds_3d_bound_tenfold(B, nc, l, H, P, N, zero, kind):
    assert _worst(_inputs(B, nc, l, H, P, N, kind, zero), terms=3) <= 0.1


@pytest.mark.parametrize("kind", ["init", "strong", "weak"])
def test_three_tf32_holds_3d_bound_tenfold_at_the_training_widths(kind):
    """mamba2-1.3B's chunk (l 256, P 64, N 128), 8 heads."""
    assert _worst(_inputs(1, 1, 256, 8, 64, 128, kind), terms=3) <= 0.1


@pytest.mark.parametrize("kind", ["init", "strong", "weak"])
def test_three_tf32_holds_3d_bound_tenfold_at_64_heads(kind):
    """3d's training widths with every head (l 256, H 64, P 64, N 128), B
    = nc = 1: dB's e x dS term sums 64 heads."""
    assert _worst(_inputs(1, 1, 256, 64, 64, 128, kind), terms=3) <= 0.1


@pytest.mark.parametrize("kind", ["init", "strong", "weak"])
@pytest.mark.parametrize("l,H,P,N", [(100, 7, 33, 40), (256, 8, 64, 128)])
def test_single_tf32_would_miss(l, H, P, N, kind):
    """One TF32 product (operands rounded to 10 mantissa bits) falls
    outside 3d's bound: the split is needed."""
    assert _worst(_inputs(1, 1, l, H, P, N, kind), terms=1) > 1.0


def test_tc_step_rounds_toward_zero():
    """One instruction's sum, exact, then truncated to float32: 1 + 0.75
    ulp goes to 1 (nearest would give 1 + 1 ulp), and likewise below
    zero; a sum float32 holds stays as it is."""
    ulp = 2.0 ** -23
    a = torch.tensor([[0.75 * ulp, 0.0], [-0.75 * ulp, 0.0], [0.5, 0.25]])
    b = torch.tensor([[1.0], [1.0]])
    acc = torch.tensor([[1.0], [-1.0], [1.0]])
    got = ssd_chunk.tc_step(acc, a, b)
    assert torch.equal(got, torch.tensor([[1.0], [-1.0], [1.75]]))
    assert torch.equal(ssd_chunk.tc_steps(torch.zeros((3, 1)), a, b, terms=3), a.sum(1, True))


def test_tf32_split_rounds_to_nearest_ties_away():
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -23, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0, 0.0], dtype=torch.float32)
    hi, lo = ssd_chunk.tf32_split(v)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0, 0.0])
    assert torch.equal(hi, want)
    assert torch.equal(hi + lo, v) or (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("H", [1, 8, 9, 64])
@pytest.mark.parametrize("kind", ["init", "strong", "weak"])
def test_dg_partials_in_group_order_hold_the_bound(H, kind):
    """The groups' partials added in group order equal the plain dG =
    sum_h R L within SSD_TOL x max(1, sum|R L|) + SSD_TOL x |plain|."""
    a, x, _, _, dy, _, _ = _inputs(1, 1, 65, H, 64, 8, kind, seed=H)
    ci = cumsum_xla(a, dim=2)[0, 0]
    tril = torch.ones((65, 65), dtype=torch.bool).tril()[..., None]
    L = torch.where(tril, torch.exp(torch.where(tril, ci[:, None] - ci[None, :], 0.0)), 0.0)
    R = torch.einsum("ihp,jhp->ijh", dy[0, 0], x[0, 0])
    got = ssd_chunk.dg_grouped(R, L)
    want = torch.einsum("ijh,ijh->ij", R, L)
    sums = torch.einsum("ijh,ijh->ij", R.abs(), L)
    bound = SSD_TOL * sums.clamp_min(1.0) + SSD_TOL * want.abs()
    assert torch.all((got - want).abs() <= bound)
    assert torch.equal(got, ssd_chunk.dg_grouped(R, L))  # one fixed order
    assert not got.triu(1).any()


def test_bwd_work_and_bounds_at_the_training_shape():
    """mamba2-1.3B's training shape: 142.29 GFLOP (140.94 of them the
    products the kernel issues three times) and 1,962.97 MB; at the H100
    data sheet's rates 2.12370 ms on the float32 CUDA cores, 0.87428 for
    the work the kernel issues, 0.58596 for the bytes."""
    nops, nbytes, products = ssd_chunk.bwd_work(8, 16, 256, 64, 64, 128)
    assert (nops, nbytes, products) == (142287568896, 1962967040, 140941197312)
    ms = ssd_chunk.bwd_bounds_ms((8, 16, 256, 64, 64, 128), 67e12, 495e12, 3.35e12)
    assert {k: round(v, 5) for k, v in ms.items()} == {"f32": 2.12370, "tf32x3": 0.87428,
                                                        "bytes": 0.58596}


def test_ssd_profile_without_a_card_builds_nothing(monkeypatch, capsys):
    from repro_torch.kernels import build
    from repro_torch.launch import ssd_profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "build_all", lambda names: pytest.fail("built without a card"))
    assert ssd_profile.main(["--old-bwd", "old_ssd_chunk_bwd.cu"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
