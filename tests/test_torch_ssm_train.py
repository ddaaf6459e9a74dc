"""The SSM family's training path against the JAX package.

* `ssd_chunk_intra_bwd_plain` (the SSD step's backward, written out as
  products) against `jax.vjp` of `repro.kernels.ref.ssd_chunk_intra_ref`,
  torch autograd of `ssd_chunk_intra_plain`, and the float64 oracle
  `ssd_chunk_intra_bwd_f64`, at l 8, 16 (one scan block) and 17 (two),
  H and P not multiples of 4, and with a zero cotangent; `ops.
  ssd_chunk_intra`'s autograd Function gives the plain backward's bits.
* The port's `ssd_chunked` gradients (x, dt, A, Bm, Cm, h0) against
  `jax.vjp` of `repro.models.mamba2.ssd_chunked`, S not a multiple of the
  chunk (dt = 0 padding), with and without h0, through both outputs.
* Tolerance: relative L2 2e-5 a gradient, float32 (tests/test_kernels.py's
  f32 scale): the sums run in other orders, and da's sums cancel.
* Under no_grad (serving) the Function saves nothing; the CUDA backward's
  wrapper refuses what its kernel does not take before any build.
* The train CLI on mamba2 SMOKE: the loss falls, and a restart resumes
  exactly (Model.loss's gradient for the whole model is
  tests/test_torch_train.py's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")

from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

TOL = 2e-5


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _step_inputs(B, nc, l, H, P, N, seed=0, zero=""):
    """a = -softplus(N(0,1)) (tests/test_kernels.py's decays: exp(ci_i -
    ci_j) above the diagonal stays finite at these lengths, so the
    reference's vjp does too), x, B, C and the cotangents normal; `zero`
    names a cotangent set to 0."""
    rng = np.random.default_rng(seed)
    a = -np.log1p(np.exp(rng.standard_normal((B, nc, l, H)))).astype(np.float32)
    x, dy = (rng.standard_normal((B, nc, l, H, P)).astype(np.float32) for _ in range(2))
    Bm, Cm = (rng.standard_normal((B, nc, l, N)).astype(np.float32) for _ in range(2))
    dS = rng.standard_normal((B, nc, H, N, P)).astype(np.float32)
    dtot = rng.standard_normal((B, nc, H)).astype(np.float32)
    cot = {"dy": dy, "dS": dS, "dtot": dtot}
    if zero:
        cot[zero] = np.zeros_like(cot[zero])
    return (a, x, Bm, Cm), (cot["dy"], cot["dS"], cot["dtot"])


SHAPES = [  # B, nc, l, H, P, N
    (2, 2, 8, 4, 8, 16),
    (1, 3, 16, 3, 5, 6),
    (2, 2, 17, 5, 7, 9),
]


@pytest.mark.parametrize("zero", ["", "dy", "dS"])
@pytest.mark.parametrize("B,nc,l,H,P,N", SHAPES)
def test_bwd_plain_matches_jax_vjp_autograd_and_f64(B, nc, l, H, P, N, zero):
    ins, cot = _step_inputs(B, nc, l, H, P, N, zero=zero)
    _, vjp = jax.vjp(jax.jit(jref.ssd_chunk_intra_ref), *ins)
    want = [np.asarray(g) for g in vjp(cot)]
    t_ins, t_cot = [torch.from_numpy(v) for v in ins], [torch.from_numpy(v) for v in cot]
    got = ssd_chunk.ssd_chunk_intra_bwd_plain(*t_ins, *t_cot)
    f64 = ssd_chunk.ssd_chunk_intra_bwd_f64(*t_ins, *t_cot)
    leaves = [v.clone().requires_grad_(True) for v in t_ins]
    auto = torch.autograd.grad(ssd_chunk.ssd_chunk_intra_plain(*leaves), leaves, t_cot)
    for name, g, w, o, au in zip(("da", "dx", "dB", "dC"), got, want, f64, auto):
        assert g.dtype == torch.float32 and g.shape == au.shape and o.dtype == torch.float64
        for other, what in ((w, "jax.vjp"), (o.numpy(), "float64"), (au.numpy(), "autograd")):
            assert _rel_l2(g.numpy(), other) <= TOL, (name, what, _rel_l2(g.numpy(), other))
    func = ops.ssd_chunk_intra
    leaves = [v.clone().requires_grad_(True) for v in t_ins]
    for g, h in zip(got, torch.autograd.grad(func(*leaves), leaves, t_cot)):
        assert torch.equal(g, h)


def test_bwd_terms_bound_the_outputs():
    """Each output's sum of |terms| bounds the output, and is 0 only where
    the output is (a zero dy and dS leave dx, dB, dC exactly 0)."""
    ins, cot = _step_inputs(1, 2, 17, 3, 5, 6, seed=3)
    t = [torch.from_numpy(v) for v in ins + cot]
    for g, s in zip(ssd_chunk.ssd_chunk_intra_bwd_f64(*t), ssd_chunk.ssd_chunk_intra_bwd_terms(*t)):
        assert torch.all(g.abs() <= s.double() * (1 + 1e-5) + 1e-30)
    t[4], t[5] = torch.zeros_like(t[4]), torch.zeros_like(t[5])
    _, dx, dB, dC = ssd_chunk.ssd_chunk_intra_bwd_plain(*t)
    assert not dx.any() and not dB.any() and not dC.any()


def _chunked_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -rng.uniform(1, 16, H).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return (x, dt, A, Bm, Cm, h0), (dy, dh)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S,chunk", [(21, 8), (16, 8), (5, 8)])
def test_ssd_chunked_gradients_match_jax(S, chunk, with_h0):
    (x, dt, A, Bm, Cm, h0), (dy, dh) = _chunked_inputs(2, S, 3, 5, 6, seed=S)
    args = (x, dt, A, Bm, Cm) + ((h0,) if with_h0 else ())

    def jfn(*a):
        return jmamba2.ssd_chunked(*a[:5], chunk, h0=a[5] if with_h0 else None)

    _, vjp = jax.vjp(jax.jit(jfn), *args)
    want = vjp((dy, dh))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in args]
    y, hT = mamba2.ssd_chunked(*leaves[:5], chunk, h0=leaves[5] if with_h0 else None)
    got = torch.autograd.grad((y, hT), leaves, (torch.from_numpy(dy), torch.from_numpy(dh)))
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm", "h0"), got, want):
        assert _rel_l2(g.numpy(), np.asarray(w)) <= TOL, (name, _rel_l2(g.numpy(), np.asarray(w)))


def test_no_grad_saves_nothing_and_the_serving_bits_hold():
    """Serving (no_grad) gives the plain forward's bits and records no
    graph; under autograd the same call gives the same forward bits."""
    ins, _ = _step_inputs(1, 2, 17, 3, 5, 6)
    t = [torch.from_numpy(v) for v in ins]
    want = ssd_chunk.ssd_chunk_intra_plain(*t)
    with torch.no_grad():
        got = ops.ssd_chunk_intra(*(v.clone().requires_grad_(True) for v in t))
    assert all(g.grad_fn is None and torch.equal(g, w) for g, w in zip(got, want))
    got = ops.ssd_chunk_intra(*(v.clone().requires_grad_(True) for v in t))
    assert all(g.grad_fn is not None and torch.equal(g, w) for g, w in zip(got, want))


def test_bwd_cuda_wrapper_checks_before_building():
    ins, cot = _step_inputs(1, 1, 4, 2, 3, 5)
    t = [torch.from_numpy(v) for v in ins + cot]
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_chunk.ssd_chunk_intra_bwd_cuda(*t)
    with pytest.raises(ValueError, match="dS must be float32"):
        ssd_chunk.ssd_chunk_intra_bwd_cuda(*t[:5], t[5].double(), t[6])
    with pytest.raises(ValueError, match="dy must be contiguous"):
        ssd_chunk.ssd_chunk_intra_bwd_cuda(*t[:4], t[4].transpose(3, 4).contiguous().transpose(3, 4),
                                           *t[5:])
    with pytest.raises(ValueError, match="dtot must be float32"):
        ssd_chunk.ssd_chunk_intra_bwd_cuda(*t[:6], t[6][..., :1])


def test_train_cli_ssm_decreases_loss_and_resumes(tmp_path):
    from repro_torch.launch.train import main as train_main

    args = ["--arch", "mamba2_1_3b", "--smoke", "--seq-len", "32", "--batch", "2", "--lr", "1e-2",
            "--warmup", "20", "--ckpt-every", "10", "--log-every", "100", "--device", "cpu"]
    first = train_main(args + ["--ckpt-dir", str(tmp_path / "a"), "--steps", "1"])
    loss_full = train_main(args + ["--ckpt-dir", str(tmp_path / "b"), "--steps", "30"])
    assert loss_full < first - 0.5  # 6.89 at init
    # steps 0-19 are the warmup in both runs, so the two schedules agree there
    train_main(args + ["--ckpt-dir", str(tmp_path / "c"), "--steps", "20"])
    assert train_main(args + ["--ckpt-dir", str(tmp_path / "c"), "--steps", "30"]) == loss_full
