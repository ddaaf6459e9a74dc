"""The attention backward against autograd and the JAX package.

`flash_attention_bwd_plain` (the plain version of the CUDA backward
kernel, csrc/flash_attention_bwd.cu) is held against torch autograd of
`flash_attention_plain` and against `jax.vjp` of the JAX model's
`attention_scores_chunked` (whose XLA autodiff is the gradient the JAX
package trains with), over the three masks, Sq != Skv, groups G 1/2/4 and
hd 16-128. Inputs and cotangents are numpy normals from a seed, handed to
both packages (bf16 rounded from the same float32 numbers on each side).
Tolerances: float32 2e-5 + 2e-5*|want|; bf16 2e-2 + 2e-2*|want|
(tests/test_kernels.py's). `ops.flash_attention` on the CPU is one
autograd Function whose backward is the plain version: every input gets
its gradient. The CUDA kernel is held against the plain version on the
card by chip_smoke.py (phase 3c), bitwise-repeatable.

The D emulation: FA2 takes D = rowsum(dO * O) from the rounded output.
In bf16 that adds O's rounding to every dS = P * (dP - D); the plain
path's D = rowsum(P * dP) does not. Both forms are emulated here in
float32 from bf16 inputs and held against the gradient of the float32
inputs, with chip_smoke's bf16 gate (error within 1.5x the plain bf16
path's): the float32 kernel takes rowsum(P * dP), which is the plain
path. The bf16 kernel takes a third form, rowsum(dO * O32) over the
forward's float32 output before its rounding: the same sum as
rowsum(P * dP) in another order, which holds the gate too.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import attention_scores_chunked  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, H, K, Sq, Skv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd), (B, H, Sq, hd))]
    tdt, jdt = DTYPES[dtype]
    return [torch.from_numpy(a).to(tdt) for a in arrs], [jnp.asarray(a).astype(jdt) for a in arrs]


def _close(got, want, dtype, what):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


CASES = [  # B, H, K, Sq, Skv, hd, mask, prefix_len
    (1, 4, 4, 64, 64, 64, "causal", 0),      # MHA
    (2, 4, 2, 96, 96, 32, "causal", 0),      # G 2
    (1, 8, 2, 80, 80, 128, "causal", 0),     # G 4, hd 128
    (1, 4, 1, 50, 120, 16, "full", 0),       # MQA, Sq < Skv
    (1, 4, 2, 130, 70, 64, "causal", 0),     # Sq > Skv: late rows see every key
    (2, 4, 2, 100, 100, 32, "prefix", 37),
    (1, 2, 1, 33, 200, 64, "prefix", 120),   # prefix past Sq
    (1, 4, 4, 1, 77, 64, "full", 0),         # one query row
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,Sq,Skv,hd,mode,prefix", CASES)
def test_plain_backward_matches_autograd_and_jax(B, H, K, Sq, Skv, hd, mode, prefix, dtype):
    (tq, tk, tv, tg), (jq, jk, jv, jg) = _inputs(B, H, K, Sq, Skv, hd, dtype, seed=Sq + Skv + hd)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, tg, mask_mode=mode, prefix_len=prefix)
    assert [x.dtype for x in got] == [tq.dtype] * 3
    assert [tuple(x.shape) for x in got] == [tuple(tq.shape), tuple(tk.shape), tuple(tv.shape)]

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    want = torch.autograd.grad(
        fa.flash_attention_plain(*leaves, mask_mode=mode, prefix_len=prefix), leaves, tg)
    for name, a, b in zip("qkv", got, want):
        _close(a, b.float().numpy(), dtype, f"d{name} vs autograd")

    G = H // K

    def ref(q, k, v):  # the JAX model's layout: q [B,S,K,G,hd], k/v [B,S,K,hd]
        qg = jnp.moveaxis(q, 1, 2).reshape(B, Sq, K, G, hd)
        y = attention_scores_chunked(qg, jnp.moveaxis(k, 1, 2), jnp.moveaxis(v, 1, 2),
                                     mask_mode=mode, q_offset=0, prefix_len=prefix, chunk=32)
        return jnp.moveaxis(y.reshape(B, Sq, H, hd), 1, 2)

    _, vjp = jax.vjp(ref, jq, jk, jv)
    for name, a, b in zip("qkv", got, vjp(jg)):
        _close(a, b, dtype, f"d{name} vs jax.vjp")


@pytest.mark.parametrize("mode,prefix", [("causal", 0), ("prefix", 20), ("full", 0)])
def test_ops_flash_attention_gives_every_input_a_gradient(mode, prefix):
    """The training path's call: q, k, v as the model's strided [B,S,H,hd]
    projections, every input's gradient nonzero and equal to autograd of
    the plain forward."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, n, 16)).astype(np.float32))
               for n in (4, 2, 2))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    y = ops.flash_attention(*(x.transpose(1, 2) for x in leaves), mask_mode=mode,
                            prefix_len=prefix)
    got = torch.autograd.grad((y * y).sum(), leaves)
    y2 = fa.flash_attention_plain(*(x.transpose(1, 2) for x in leaves), mask_mode=mode,
                                  prefix_len=prefix)
    want = torch.autograd.grad((y2 * y2).sum(), leaves)
    for a, b in zip(got, want):
        assert bool((a != 0).any())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)


def test_serving_call_saves_nothing_for_autograd():
    """Without an input that needs a gradient the Function records no
    graph: the serving path is unchanged."""
    q, k = torch.zeros((1, 2, 3, 16)), torch.zeros((1, 1, 3, 16))
    y = ops.flash_attention(q, k, k)
    assert y.grad_fn is None and not y.requires_grad


def test_backward_cuda_wrapper_refuses_before_building(monkeypatch):
    """hd 256 (and any hd the backward has no instance for), a dtype or a
    shape it does not take raise ValueError before a build."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(fa.build, "load", no_build)
    for hd in (256, 48):
        q, k = torch.zeros((1, 2, 8, hd)), torch.zeros((1, 1, 8, hd))
        with pytest.raises(ValueError, match="hd"):
            fa.flash_attention_bwd_cuda(q, k, k, q)
    q16, k = torch.zeros((1, 2, 8, 16), dtype=torch.float16), torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_bwd_cuda(q16, k, k, q16)
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd_cuda(q, k, k, q[:, :, :4])
    assert fa.bwd_launches == 0 and 256 not in fa.BWD_HEAD_DIMS


# --- D: rowsum(P * dP) (the kernel's) against FA2's rowsum(dO * O) ------

def _emulated_grads(q, k, v, dout, delta):
    """dq, dk, dv in float32 from these inputs, causal, with D either
    'probs' (rowsum(P * dP)), 'output' (rowsum(dO * O), O the forward's
    output rounded to q's dtype) or 'output32' (rowsum(dO * O32), O32 the
    forward's float32 output before that rounding), each rounded to its
    input's dtype."""
    B, H, S, hd = q.shape
    K, G, scale = k.shape[1], H // k.shape[1], 1.0 / math.sqrt(hd)
    qs = (q.float() * scale).reshape(B, K, G, S, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qs, k.float())
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, fa.NEG_INF)
    p = torch.softmax(s, dim=-1)
    g = dout.float().reshape(B, K, G, S, hd)
    dp = torch.einsum("bkgqd,bksd->bkgqs", g, v.float())
    if delta == "probs":
        D = (p * dp).sum(-1, keepdim=True)
    else:
        o = (fa.flash_attention_plain(q, k, v).float() if delta == "output" else
             fa.flash_attention_plain(q.float(), k.float(), v.float()))
        D = (g * o.reshape(B, K, G, S, hd)).sum(-1, keepdim=True)
    ds = p * (dp - D)
    dq = (torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * scale).reshape(B, H, S, hd)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qs)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, g)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("H,K,hd", [(4, 4, 64), (8, 2, 128)])
def test_delta_form_holds_the_bf16_gate(H, K, hd):
    (q, k, v, g), _ = _inputs(1, H, K, 512, 512, hd, "bfloat16", seed=hd)
    exact = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float())
    plain = fa.flash_attention_bwd_plain(q, k, v, g)  # the plain bf16 path chip_smoke gates on

    def errors(grads):
        return [float((a.float() - b).abs().max()) for a, b in zip(grads, exact)]

    e_plain, e_probs = errors(plain), errors(_emulated_grads(q, k, v, g, "probs"))
    e_output = errors(_emulated_grads(q, k, v, g, "output"))
    for p_, pr in zip(e_plain, e_probs):
        assert pr <= 1.5 * p_  # the kernel's form: the plain path's error (a final rounding)
    # FA2's form adds O's rounding to dS: dq and dk move further from the
    # float32 gradient (dv does not read D)
    assert e_output[0] > e_probs[0] or e_output[1] > e_probs[1]
    assert e_output[2] == e_probs[2]


@pytest.mark.parametrize("H,K,hd", [(4, 4, 64), (8, 2, 128)])
def test_delta_from_the_float32_output_holds_the_bf16_gate(H, K, hd):
    """The bf16 kernel's D: rowsum(dO * O32), O32 the forward's output
    before rounding (sum_d dO_d sum_j P_j v_jd = sum_j P_j dP_j)."""
    (q, k, v, g), _ = _inputs(1, H, K, 512, 512, hd, "bfloat16", seed=hd)
    exact = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float())
    plain = fa.flash_attention_bwd_plain(q, k, v, g)

    def errors(grads):
        return [float((a.float() - b).abs().max()) for a, b in zip(grads, exact)]

    e_plain, e_o32 = errors(plain), errors(_emulated_grads(q, k, v, g, "output32"))
    for p_, o_ in zip(e_plain, e_o32):
        assert o_ <= 1.5 * p_
    e_output = errors(_emulated_grads(q, k, v, g, "output"))
    assert e_output[0] > e_o32[0] or e_output[1] > e_o32[1]  # O's rounding is what costs
