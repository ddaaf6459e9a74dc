"""The bf16 attention backward's design on the CPU (csrc/flash_attention_bwd.cu,
namespace `tc`).

The kernel computes in float32 from bf16 operands and rounds at a few
points where a product's operand must be bf16. This file emulates that
arithmetic in float32 and holds it to chip_smoke.py phase 3c's bf16 gate:
each gradient's max abs error from the float32 plain gradient at most 1.5x
the plain bf16 path's (`ATTN_BWD_RATIO`). Emulated: the forward's
log-sum-exp in the log2 domain (lse = m c + log2 l, c = log2(e)/sqrt(hd)),
its float32 output O32 (P split into hi + lo, as attention_tc runs P.V),
D = rowsum(dO * O32), P = 2^(S c - lse), dS = P (dP - D) with S and dP
exact products of bf16 operands summed in float32. P^T (into dv = P^T.dO),
dS^T (into dk = dS^T.Q) and dS (into dq = dS.K) enter either as one bf16
rounding or split as hi = bf16(x), lo = bf16(x - hi). The cases are
CPU-sized versions of 3c's edges: Sq 63 and 65 against 1,000 keys, prefix
1/255/256/257, hd 16 and 128, groups G 1, 2 and 4. One rounding misses the
gate for each of the three (so the kernel splits all three); the split
holds it everywhere.

Also: `ops.flash_attention` asks the forward kernel for the statistics
only under autograd and hands them to the backward kernel, and the CUDA
wrappers refuse what the bf16 route does not take before anything is
built. The kernel itself is held to its plain version on the card by
chip_smoke.py (phase 3c).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

LOG2E = 1.4426950408889634
RATIO = 1.5  # chip_smoke.py's ATTN_BWD_RATIO


def _inputs(B, H, K, Sq, Skv, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
            for s in ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd), (B, H, Sq, hd))]


def _bf(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    hi = _bf(x)
    return hi + _bf(x - hi)


def _mask(Sq, Skv, mode, prefix_len):
    q_pos, k_pos = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    if mode == "full":
        return torch.ones(Sq, Skv, dtype=torch.bool)
    return (k_pos <= q_pos) | ((k_pos < prefix_len) if mode == "prefix" else False)


def _tc_emulation(q, k, v, dout, mode, prefix_len, split):
    """dq, dk, dv (bf16) as the tensor-core kernel computes them; `split`
    names which of "p", "dsk", "dsq" enter their product as hi + lo."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G, scale = H // K, 1.0 / math.sqrt(hd)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf, gf = (x.float().reshape(B, K, G, Sq, hd) for x in (q, dout))
    kf, vf = k.float(), v.float()
    mask = _mask(Sq, Skv, mode, prefix_len)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf)  # raw scores
    m = torch.where(mask, s, -torch.inf).amax(-1, keepdim=True)
    e = torch.where(mask, torch.exp2(s * c - m * c), 0.0)  # the forward's weights
    l = e.sum(-1, keepdim=True)
    lse = m * c + torch.log2(l)
    o32 = torch.einsum("bkgqs,bksd->bkgqd", _split(e), vf) / l
    D = (gf * o32).sum(-1, keepdim=True)
    p = torch.where(mask, torch.exp2(s * c - lse), 0.0)
    dp = torch.einsum("bkgqd,bksd->bkgqs", gf, vf)
    ds = p * (dp - D)
    op = {name: (_split if name in split else _bf) for name in ("p", "dsk", "dsq")}
    dv = torch.einsum("bkgqs,bkgqd->bksd", op["p"](p), gf)
    dk = torch.einsum("bkgqs,bkgqd->bksd", op["dsk"](ds), qf) * scale
    dq = (torch.einsum("bkgqs,bksd->bkgqd", op["dsq"](ds), kf) * scale).reshape(B, H, Sq, hd)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


CASES = [  # B, H, K, Sq, Skv, hd, mask, prefix_len
    (1, 4, 4, 512, 512, 64, "causal", 0),     # the training shape's mask, MHA
    (1, 4, 4, 63, 1000, 64, "full", 0),
    (1, 4, 4, 65, 1000, 64, "causal", 0),
    (1, 4, 2, 63, 1000, 128, "prefix", 500),
    (1, 8, 2, 256, 256, 128, "causal", 0),    # G 4
    (1, 8, 2, 333, 333, 16, "causal", 0),
    (1, 8, 4, 300, 500, 32, "full", 0),
] + [(1, 4, 2, 512, 512, 64, "prefix", p) for p in (1, 255, 256, 257)]

_REF = {}


def _errors(case, split):
    """(the emulation's, the plain bf16 path's) max abs errors of dq, dk,
    dv from the float32 plain gradient."""
    B, H, K, Sq, Skv, hd, mode, pl = case
    if case not in _REF:
        q, k, v, g = _inputs(B, H, K, Sq, Skv, hd, seed=Sq + Skv + hd + pl)
        exact = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float(),
                                             mask_mode=mode, prefix_len=pl)
        plain = fa.flash_attention_bwd_plain(q, k, v, g, mask_mode=mode, prefix_len=pl)
        _REF[case] = ((q, k, v, g), exact, [float((a.float() - b).abs().max())
                                            for a, b in zip(plain, exact)])
    (q, k, v, g), exact, e_plain = _REF[case]
    got = _tc_emulation(q, k, v, g, mode, pl, split)
    return [float((a.float() - b).abs().max()) for a, b in zip(got, exact)], e_plain


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}H{}K{}Sq{}Skv{}hd{}-{}{}".format(*c))
def test_split_operands_hold_the_bf16_gate(case):
    errs, e_plain = _errors(case, split=("p", "dsk", "dsq"))
    for name, e, p in zip(("dq", "dk", "dv"), errs, e_plain):
        assert e <= RATIO * p, f"{name}: {e:.3e} against the plain path's {p:.3e}"


# one rounding misses the gate: dq and dk on the causal cases (rows and
# keys with few partners, where dS cancels), dv at the first prefix edge
ONE_ROUNDING_MISSES = [("dq", CASES[2]), ("dk", CASES[0]), ("dv", CASES[7])]


@pytest.mark.parametrize("grad,case", ONE_ROUNDING_MISSES, ids=lambda x: x if isinstance(x, str)
                         else "Sq{}Skv{}hd{}-{}{}".format(*x[3:]))
def test_one_rounding_misses_the_bf16_gate(grad, case):
    i = ("dq", "dk", "dv").index(grad)
    errs, e_plain = _errors(case, split=())
    assert errs[i] > RATIO * e_plain[i]
    # and splitting that operand alone brings it back
    errs, e_plain = _errors(case, split=(("dsq", "dsk", "p")[i],))
    assert errs[i] <= RATIO * e_plain[i]


# --- ops.flash_attention: the statistics only under autograd ------------

def _recording(monkeypatch):
    """ops routed to recording stand-ins for the CUDA wrappers (their
    arithmetic the plain versions', the statistics made up)."""
    calls = []

    def fwd(q, k, v, *, mask_mode, prefix_len, stats=False):
        calls.append(("fwd", stats))
        out = fa.flash_attention_plain(q, k, v, mask_mode=mask_mode, prefix_len=prefix_len)
        B, H, Sq, hd = q.shape
        return (out, torch.zeros(B, H, Sq), torch.zeros(B, H, Sq, hd)) if stats else out

    def bwd(q, k, v, dout, *, mask_mode, prefix_len, lse=None, o32=None):
        calls.append(("bwd", lse is not None and o32 is not None))
        return fa.flash_attention_bwd_plain(q, k, v, dout, mask_mode=mask_mode,
                                            prefix_len=prefix_len)

    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "_pick", lambda x, plain, cuda, what: cuda)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_statistics_only_under_autograd(monkeypatch, dtype):
    calls = _recording(monkeypatch)
    q, k = torch.randn((1, 2, 8, 16)).to(dtype), torch.randn((1, 1, 8, 16)).to(dtype)
    y = ops.flash_attention(q, k, k)  # serving: nothing saved, nothing asked
    assert y.grad_fn is None and calls == [("fwd", False)]
    calls.clear()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, k)]
    y = ops.flash_attention(*leaves, mask_mode="prefix", prefix_len=3)
    torch.autograd.grad(y.float().sum(), leaves)
    bf16 = dtype == torch.bfloat16  # only the bf16 kernels write and read them
    assert calls == [("fwd", bf16), ("bwd", bf16)]


def test_statistics_are_saved_with_the_inputs(monkeypatch):
    _recording(monkeypatch)
    leaves = [torch.randn(s).bfloat16().requires_grad_(True)
              for s in ((1, 2, 8, 16), (1, 1, 8, 16), (1, 1, 8, 16))]
    y = ops.flash_attention(*leaves)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5 and [tuple(x.shape) for x in saved[3:]] == [(1, 2, 8), (1, 2, 8, 16)]


# --- the wrappers refuse before anything is built -----------------------

def _no_build(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(fa.build, "load", no_build)


def test_bf16_backward_refuses_before_building(monkeypatch):
    _no_build(monkeypatch)
    bf = torch.bfloat16
    q, k = torch.zeros((1, 2, 8, 64), dtype=bf), torch.zeros((1, 1, 8, 64), dtype=bf)
    lse, o32 = fa._row_stats(1, 2, 8, "cpu"), torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="lse and o32"):
        fa.flash_attention_bwd_cuda(q, k, k, q)
    with pytest.raises(ValueError, match="lse must be"):  # rows 36 bytes apart
        fa.flash_attention_bwd_cuda(q, k, k, q, lse=torch.zeros((1, 2, 9))[..., :8], o32=o32)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd_cuda(q, k, k, q, lse=lse, o32=o32[:, :, :4])
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd_cuda(q, k, k, q, lse=lse.double(), o32=o32)
    with pytest.raises(ValueError, match="TMA"):  # dout's s stride 130 bytes
        g = torch.zeros((1, 2, 8, 65), dtype=bf)[..., :64]
        fa.flash_attention_bwd_cuda(q, k, k, g, lse=lse, o32=o32)
    with pytest.raises(ValueError, match="hd"):
        q2, k2 = torch.zeros((1, 2, 8, 256), dtype=bf), torch.zeros((1, 1, 8, 256), dtype=bf)
        fa.flash_attention_bwd_cuda(q2, k2, k2, q2, lse=lse, o32=torch.zeros((1, 2, 8, 256)))
    with pytest.raises(ValueError, match="float32 kernel takes no"):
        qf, kf = q.float(), k.float()
        fa.flash_attention_bwd_cuda(qf, kf, kf, qf, lse=lse, o32=o32)
    assert fa.bwd_launches == 0


def test_forward_statistics_refused_where_no_backward_reads_them(monkeypatch):
    _no_build(monkeypatch)
    for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 256)):
        q, k = torch.zeros((1, 2, 8, hd), dtype=dtype), torch.zeros((1, 1, 8, hd), dtype=dtype)
        with pytest.raises(ValueError, match="stats"):
            fa.flash_attention_cuda(q, k, k, stats=True)
    assert fa.launches == 0


def test_row_statistics_are_tma_loadable():
    for Sq in (1, 63, 64, 65, 333):
        x = fa._row_stats(2, 3, Sq, "cpu")
        assert tuple(x.shape) == (2, 3, Sq) and x.stride(2) == 1
        assert x.stride(1) % 4 == 0 and x.stride(0) % 4 == 0 and x.stride(1) >= Sq


def test_no_statistics_at_a_head_dim_the_backward_lacks(monkeypatch):
    """At hd 256 the forward runs as before under autograd (nothing more
    asked); the backward kernel refuses that hd when it is reached."""
    calls = _recording(monkeypatch)
    leaves = [torch.randn(s).bfloat16().requires_grad_(True)
              for s in ((1, 2, 8, 256), (1, 1, 8, 256), (1, 1, 8, 256))]
    ops.flash_attention(*leaves)
    assert calls == [("fwd", False)]
