"""Mamba-2 SSD intra-chunk step: plain PyTorch version and CUDA wrapper.

Counterpart of `repro.kernels.ssd_chunk.ssd_chunk_intra` (Pallas) and of
its oracle `repro.kernels.ref.ssd_chunk_intra_ref`, with their contract:
a [B,nc,l,H] log-decays, x [B,nc,l,H,P] dt-weighted inputs, Bm/Cm
[B,nc,l,N] -> (y_diag [B,nc,l,H,P], S_c [B,nc,H,N,P], total [B,nc,H]),
all float32. With ci the prefix sum of a over each chunk,
  y_diag[i] = sum_{j<=i} (C_i . B_j) exp(ci_i - ci_j) x_j,
  S_c       = sum_j B_j (x) x_j exp(ci_last - ci_j),   total = exp(ci_last).
ci is summed in XLA:CPU's order (`numerics.cumsum_xla`), as the JAX
package computes it: with the decays of the repo's init |ci| reaches
thousands within a 256-long chunk, where a sum in another order moves
exp(ci_i - ci_j) by up to 5e-4 relative. The kernel lives in
`csrc/ssd_chunk.cu`; its source note gives its bound and design.

The step's backward, (dy, dS, dtot) -> (da, dx, dB, dC), has its own
kernel (`csrc/ssd_chunk_bwd.cu`) and plain version. With G[i,j] = C_i.B_j,
L[i,j,h] = exp(ci_i - ci_j) (i >= j), W = G L and e_j = exp(ci_last - ci_j):
  R[i,j,h]  = sum_p dy[i,h,p] x[j,h,p]        U[j,h,p] = sum_n B[j,n] dS[h,n,p]
  dx[j,h,p] = sum_{i>=j} W[i,j,h] dy[i,h,p] + e_j U[j,h,p]
  dG[i,j]   = sum_h R[i,j,h] L[i,j,h]
  dC_i      = sum_{j<=i} dG[i,j] B_j
  dB_j      = sum_{i>=j} dG[i,j] C_i + sum_h e_j[h] T[j,h,:],  T = sum_p dS[h,:,p] x[j,h,p]
  dci       = Q's row sums - Q's column sums - E,  Q = W R,  E_j = e_j (B_j . T[j,h,:])
  dci_last += sum_j E_j + dtot total;   da = the reverse prefix sum of dci
as JAX's autodiff of `kernels/ref.py::ssd_chunk_intra_ref` forms them,
except that Q's diagonal is left out: its terms cancel in dci exactly,
and where the decays are strong they are most of each row's and column's
sum, so adding them first would cancel the rest's last bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.numerics import cumsum_xla

MAX_L, MAX_P, MAX_N = 256, 64, 256  # what the kernel takes

# Launches of the CUDA kernels in this process (read by chip_smoke.py).
launches = 0
bwd_launches = 0


def ssd_chunk_intra_plain(a, x, Bm, Cm):
    """-> (y_diag, S_c, total), float32, as `kernels/ref.py` writes them.
    One batch row at a time (the peak is one [nc,l,l,H] decay block);
    that changes no entry's arithmetic."""
    a, x, Bm, Cm = a.float(), x.float(), Bm.float(), Cm.float()
    B, nc, l, H = a.shape
    ci = cumsum_xla(a, dim=2)  # [B,nc,l,H]
    tril = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()[..., None]
    y = torch.empty_like(x)
    for b in range(B):
        diff = ci[b, :, :, None, :] - ci[b, :, None, :, :]  # [nc,i,j,H]
        Lmat = torch.where(tril, torch.exp(diff), 0.0)
        scores = torch.einsum("cin,cjn->cij", Cm[b], Bm[b])
        y[b] = torch.einsum("cijh,cjhp->cihp", scores[..., None] * Lmat, x[b])
    decay_end = torch.exp(ci[:, :, -1:, :] - ci)  # [B,nc,l,H]
    S_c = torch.einsum("bcjn,bcjhp->bchnp", Bm, x * decay_end[..., None])
    total = torch.exp(ci[:, :, -1, :])
    return y, S_c, total


def ssd_chunk_intra_f64(a, x, Bm, Cm):
    """The same step evaluated in float64 (the prefix sum in index order:
    at float64 its order is immaterial) -> (y_diag, S_c, total), float64:
    an oracle for the accuracy of the float32 versions."""
    a, x, Bm, Cm = a.double(), x.double(), Bm.double(), Cm.double()
    ci = torch.cumsum(a, dim=2)
    l = a.shape[2]
    tril = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()[..., None]
    y = torch.empty_like(x)
    for b in range(a.shape[0]):
        diff = torch.where(tril, ci[b, :, :, None, :] - ci[b, :, None, :, :], 0.0)
        Lmat = torch.where(tril, torch.exp(diff), 0.0)
        scores = torch.einsum("cin,cjn->cij", Cm[b], Bm[b])
        y[b] = torch.einsum("cijh,cjhp->cihp", scores[..., None] * Lmat, x[b])
    decay_end = torch.exp(ci[:, :, -1:, :] - ci)
    S_c = torch.einsum("bcjn,bcjhp->bchnp", Bm, x * decay_end[..., None])
    return y, S_c, torch.exp(ci[:, :, -1, :])


def _bwd(a, x, Bm, Cm, dy, dS, dtot, dtype, cumsum, absolute=False):
    """The backward above in `dtype`, one batch row at a time (the peak is
    a few [nc,l,l,H] blocks). With `absolute`, every input is taken by its
    absolute value and every term added: per output, the sum of the
    absolute values of the terms of its sums (the scale of its rounding
    error)."""
    t = [v.to(dtype) for v in (a, x, Bm, Cm, dy, dS, dtot)]
    a, x, Bm, Cm, dy, dS, dtot = t
    if absolute:
        x, Bm, Cm, dy, dS, dtot = (v.abs() for v in (x, Bm, Cm, dy, dS, dtot))
    B, nc, l, H = a.shape
    ci = cumsum(a, dim=2)  # [B,nc,l,H]
    tril = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()[..., None]
    below = torch.ones((l, l), dtype=torch.bool, device=a.device).tril(-1)[..., None]
    e = torch.exp(ci[:, :, -1:, :] - ci)  # [B,nc,l,H]
    total = torch.exp(ci[:, :, -1, :])    # [B,nc,H]
    da, dx = torch.empty_like(a), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    for b in range(B):
        diff = torch.where(tril, ci[b, :, :, None, :] - ci[b, :, None, :, :], 0.0)
        L = torch.where(tril, torch.exp(diff), 0.0)                 # [nc,i,j,H]
        G = torch.einsum("cin,cjn->cij", Cm[b], Bm[b])
        W = G[..., None] * L
        R = torch.einsum("cihp,cjhp->cijh", dy[b], x[b])
        Q = torch.where(below, W * R, 0.0)  # the diagonal's terms cancel in dci: left out
        U = torch.einsum("cjn,chnp->cjhp", Bm[b], dS[b])
        T = torch.einsum("chnp,cjhp->cjhn", dS[b], x[b])
        E = e[b] * torch.einsum("cjn,cjhn->cjh", Bm[b], T)
        dx[b] = torch.einsum("cijh,cihp->cjhp", W, dy[b]) + e[b][..., None] * U
        dG = torch.einsum("cijh,cijh->cij", R, L)
        dC[b] = torch.einsum("cij,cjn->cin", dG, Bm[b])
        dB[b] = torch.einsum("cij,cin->cjn", dG, Cm[b]) + torch.einsum("cjh,cjhn->cjn", e[b], T)
        dci = Q.sum(2) + Q.sum(1) + E if absolute else Q.sum(2) - Q.sum(1) - E
        dci[:, -1] += E.sum(1) + dtot[b] * total[b]
        da[b] = dci.flip(1).cumsum(1).flip(1)
    return da, dx, dB, dC


def ssd_chunk_intra_bwd_plain(a, x, Bm, Cm, dy, dS, dtot):
    """The step's backward: the cotangents dy [B,nc,l,H,P], dS
    [B,nc,H,N,P], dtot [B,nc,H] of (y_diag, S_c, total) -> (da, dx, dB,
    dC), float32, written out as products (not autograd). ci is summed in
    XLA:CPU's order, as the forward sums it."""
    return _bwd(a, x, Bm, Cm, dy, dS, dtot, torch.float32, cumsum_xla)


def ssd_chunk_intra_bwd_f64(a, x, Bm, Cm, dy, dS, dtot):
    """The same backward in float64 (the prefix sum in index order) ->
    (da, dx, dB, dC), float64: an oracle for the float32 versions."""
    return _bwd(a, x, Bm, Cm, dy, dS, dtot, torch.float64, torch.cumsum)


def ssd_chunk_intra_bwd_terms(a, x, Bm, Cm, dy, dS, dtot):
    """Per output of the backward, float32, the sum of the absolute
    values of the terms of its sums (the decays as given): what two
    summation orders' results may differ by, times n 2**-24."""
    return _bwd(a, x, Bm, Cm, dy, dS, dtot, torch.float32, cumsum_xla, absolute=True)


HEAD_GROUP = 8  # heads a block of the kernel's head pass sums dG over (csrc: kHg)


def bwd_work(B, nc, l, H, P, N) -> tuple:
    """(operations, bytes, products) of ssd_chunk_intra_bwd's function, 2
    an FMA: R and the dy term of dx over the causal pairs (P deep), U and
    the e x dS term of dB over every (j, n) pair (P and N deep), the
    scores, dC and dB's dG term over the causal pairs (N deep), dG over
    the heads, E = e (x . U), the weights W = G L and Q = W R; a, x, B, C,
    dy, dS, dtot read and da, dx, dB, dC written once, float32. The
    products alone are what the kernel issues three times on the tensor
    cores (3xTF32)."""
    pairs = l * (l + 1) // 2
    products = 2 * B * nc * (2 * H * pairs * P + 2 * l * H * N * P + 3 * pairs * N)
    nops = products + B * nc * (2 * (H * pairs + l * H * P) + 2 * H * pairs)
    nbytes = 4 * B * nc * (2 * (l * H + l * H * P + 2 * l * N) + l * H * P + H * N * P + H)
    return nops, nbytes, products


def bwd_bounds_ms(shape, fp32_ops_per_s, tf32_ops_per_s, bytes_per_s) -> dict:
    """`bwd_work(*shape)` as times at the given rates: "f32" every
    operation on the float32 CUDA cores, "tf32x3" the products issued
    three times on the tensor cores and the rest on the CUDA cores (the
    kernel's work), "bytes" the bytes at the memory rate."""
    nops, nbytes, products = bwd_work(*shape)
    return {"f32": nops / fp32_ops_per_s * 1e3,
            "tf32x3": (3 * products / tf32_ops_per_s + (nops - products) / fp32_ops_per_s) * 1e3,
            "bytes": nbytes / bytes_per_s * 1e3}


# ---- the kernel's tensor-core arithmetic, emulated ----------------------
# Each float32 operand v is split into hi = tf32(v) and lo = tf32(v - hi)
# (cvt.rna.tf32.f32), and a product accumulates, one k8 step at a time,
# lo.hi, hi.lo and hi.hi (3xTF32), or hi.hi alone (one TF32 product). Each
# mma.sync instruction is modelled as the tensor cores are taken to add:
# its 8 products and the float32 accumulator summed exactly (float64),
# rounded once to float32 toward zero (the accumulator truncated). The
# forward's tests use the same model (tests/test_torch_ssd_chunk.py).


def tf32(v):
    """float32 v rounded as cvt.rna.tf32.f32 rounds: to nearest, ties away
    from zero, 10 mantissa bits."""
    return ((v.float().contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(v):
    """(hi, lo) of float32 v as the kernel splits an operand for the
    tensor cores: hi = tf32(v), lo = tf32(v - hi). v - hi is exact in
    float32."""
    v = v.float()
    hi = tf32(v)
    return hi, tf32(v - hi)


def tc_step(acc, a, b):
    """acc + a @ b as one tensor-core instruction forms it (a's last and
    b's second last dimension at most 8 deep): the products and acc summed
    exactly, rounded once to float32 toward zero."""
    exact = acc.double() + a.double() @ b.double()
    out = exact.float()
    over = out.double().abs() > exact.abs()  # rounded away from zero
    return torch.where(over, torch.nextafter(out, torch.zeros_like(out)), out)


def tc_steps(acc, a, b, terms=3):
    """acc [..., M, N] += a [..., M, K] @ b [..., K, N] as the kernel
    issues it: K in steps of 8, each step's products (3: lo.hi, hi.lo,
    hi.hi; 1: hi.hi) a `tc_step` each."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
    for k in range(0, a.shape[-1], 8):
        for pa, pb in pairs:
            acc = tc_step(acc, pa[..., k:k + 8], pb[..., k:k + 8, :])
    return acc


def dg_grouped(R, L, group=HEAD_GROUP):
    """dG = sum_h R L [..., i, j, h] -> [..., i, j] in the kernel's order:
    a float32 fused multiply-add a head, in head order, inside each group
    of `group` heads, then the groups' partials added in group order."""
    total = None
    for g0 in range(0, R.shape[-1], group):
        acc = torch.zeros(R.shape[:-1], dtype=torch.float32, device=R.device)
        for h in range(g0, min(g0 + group, R.shape[-1])):  # fmaf: one rounding a head
            acc = (R[..., h].double() * L[..., h].double() + acc.double()).float()
        total = acc if total is None else total + acc
    return total


def ssd_chunk_intra_bwd_tc(a, x, Bm, Cm, dy, dS, dtot, terms=3):
    """The backward with the kernel's arithmetic -> (da, dx, dB, dC),
    float32. Its products on the tensor cores (`tc_steps`, 3xTF32, or one
    TF32 product with terms 1), each in the kernel's accumulators and
    order of k8 steps: G over the states; U over the states, scaled by e,
    then dx's dy term over the rows i in the same accumulator; R over the
    columns p; dC over j; dB over i, then each head's (e x) . dS^T over p
    in an accumulator of its own (x scaled by e before its split), added
    to dB's in float32, head by head. A step whose products are all zero
    leaves an accumulator as it is, so the steps the kernel skips (the
    rows above a column tile, the columns past a row tile) are taken here
    over zeros. The rest as the kernel computes it on the CUDA cores, in
    float32: W = G L, Q = W R below the diagonal and its sums,
    E_j = e_j (x_j . U_j), dG over the heads in `dg_grouped`'s order, da's
    reverse prefix sum (these sums in torch's order, not the kernel's)."""
    a, x, Bm, Cm, dy, dS, dtot = (v.float() for v in (a, x, Bm, Cm, dy, dS, dtot))
    B, nc, l, H = a.shape
    ci = cumsum_xla(a, dim=2)
    tril = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    below = torch.ones((l, l), dtype=torch.bool, device=a.device).tril(-1)
    e = torch.exp(ci[:, :, -1:, :] - ci)  # [B, nc, l, H]
    total = torch.exp(ci[:, :, -1, :])
    da, dx = torch.empty_like(a), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    for b in range(B):
        cih = ci[b].transpose(1, 2)  # [nc, H, l]
        diff = torch.where(tril, cih[..., :, None] - cih[..., None, :], 0.0)
        L = torch.where(tril, torch.exp(diff), 0.0)  # [nc, H, i, j]
        G = tc_steps(torch.zeros((nc, l, l), device=a.device), Cm[b], Bm[b].transpose(1, 2),
                     terms)
        W = G[:, None] * L
        xh, dyh = x[b].transpose(1, 2), dy[b].transpose(1, 2)  # [nc, H, l, P]
        eh = e[b].transpose(1, 2)[..., None]  # [nc, H, l, 1]
        R = tc_steps(torch.zeros_like(W), dyh, xh.transpose(2, 3), terms)
        U = tc_steps(torch.zeros_like(xh), Bm[b][:, None], dS[b], terms)  # [nc, H, j, P]
        E = eh[..., 0] * (xh * U).sum(-1)  # [nc, H, j]
        dx[b] = tc_steps(eh * U, W.transpose(2, 3), dyh, terms).transpose(1, 2)
        Q = torch.where(below, W * R, 0.0)
        dG = dg_grouped(R.permute(0, 2, 3, 1), L.permute(0, 2, 3, 1))  # [nc, i, j]
        dC[b] = tc_steps(torch.zeros_like(Cm[b]), dG, Bm[b], terms)
        acc = tc_steps(torch.zeros_like(Bm[b]), dG.transpose(1, 2), Cm[b], terms)
        ex = eh * xh
        for h in range(H):  # each head's term in an accumulator of its own
            acc = acc + tc_steps(torch.zeros_like(acc), ex[:, h], dS[b, :, h].transpose(1, 2),
                                 terms)
        dB[b] = acc
        dci = Q.sum(3) - Q.sum(2) - E  # [nc, H, l]
        dci[..., -1] += E.sum(2) + dtot[b] * total[b]
        da[b] = dci.flip(2).cumsum(2).flip(2).transpose(1, 2)
    return da, dx, dB, dC


def _lib():
    lib = build.load("ssd_chunk")
    if lib.ssd_chunk_intra_launch.argtypes is None:
        lib.ssd_chunk_intra_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.ssd_chunk_intra_launch.restype = ctypes.c_int
    return lib


def ssd_chunk_intra_cuda(a, x, Bm, Cm):
    """Launches csrc/ssd_chunk.cu on PyTorch's current stream. Takes
    contiguous float32 tensors on one CUDA device, l <= 256, P <= 64,
    N <= 256, and raises on anything else (before any build)."""
    global launches
    if a.dim() != 4:
        raise ValueError(f"ssd_chunk_intra: a must be [B,nc,l,H], got {tuple(a.shape)}")
    B, nc, l, H = a.shape
    P, N = x.shape[-1], Bm.shape[-1]
    dev = a.device
    want = {"a": (a, (B, nc, l, H)), "x": (x, (B, nc, l, H, P)), "Bm": (Bm, (B, nc, l, N)),
            "Cm": (Cm, (B, nc, l, N))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"ssd_chunk_intra: {name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk_intra: {name} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk_intra: the kernel runs on a CUDA device, not {dev}")
    if not (1 <= l <= MAX_L and 1 <= P <= MAX_P and 1 <= N <= MAX_N and min(B, nc, H) >= 1
            and max(B, nc) <= 65535):
        raise ValueError(f"ssd_chunk_intra: unsupported shape l={l} P={P} N={N} B={B} nc={nc} "
                         f"H={H} (l <= {MAX_L}, P <= {MAX_P}, N <= {MAX_N})")
    lib = _lib()
    y = torch.empty((B, nc, l, H, P), dtype=torch.float32, device=dev)
    S_c = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=dev)
    total = torch.empty((B, nc, H), dtype=torch.float32, device=dev)
    status = lib.ssd_chunk_intra_launch(
        a.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), S_c.data_ptr(),
        total.data_ptr(), B, nc, l, H, P, N, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "ssd_chunk_intra")
    launches += 1
    return y, S_c, total


def _bwd_lib():
    lib = build.load("ssd_chunk_bwd")
    if lib.ssd_chunk_bwd_launch.argtypes is None:
        lib.ssd_chunk_bwd_launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.ssd_chunk_bwd_launch.restype = ctypes.c_int
    return lib


def ssd_chunk_intra_bwd_cuda(a, x, Bm, Cm, dy, dS, dtot):
    """Launches csrc/ssd_chunk_bwd.cu on PyTorch's current stream: the
    backward of `ssd_chunk_intra_cuda` -> (da, dx, dB, dC). Takes the
    forward's shapes plus dy [B,nc,l,H,P], dS [B,nc,H,N,P], dtot
    [B,nc,H], all contiguous float32 on one CUDA device, and raises on
    anything else (before any build). Scratch (the scores, their
    gradient and its partials by groups of HEAD_GROUP heads, e) comes
    from torch.empty."""
    global bwd_launches
    if a.dim() != 4:
        raise ValueError(f"ssd_chunk_intra_bwd: a must be [B,nc,l,H], got {tuple(a.shape)}")
    B, nc, l, H = a.shape
    P, N = x.shape[-1], Bm.shape[-1]
    dev = a.device
    want = {"a": (a, (B, nc, l, H)), "x": (x, (B, nc, l, H, P)), "Bm": (Bm, (B, nc, l, N)),
            "Cm": (Cm, (B, nc, l, N)), "dy": (dy, (B, nc, l, H, P)),
            "dS": (dS, (B, nc, H, N, P)), "dtot": (dtot, (B, nc, H))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"ssd_chunk_intra_bwd: {name} must be float32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk_intra_bwd: {name} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk_intra_bwd: the kernel runs on a CUDA device, not {dev}")
    if not (1 <= l <= MAX_L and 1 <= P <= MAX_P and 1 <= N <= MAX_N and min(B, nc, H) >= 1
            and max(B, nc) <= 65535 and H <= 65535):
        raise ValueError(f"ssd_chunk_intra_bwd: unsupported shape l={l} P={P} N={N} B={B} "
                         f"nc={nc} H={H} (l <= {MAX_L}, P <= {MAX_P}, N <= {MAX_N})")
    lib = _bwd_lib()
    da, dx = torch.empty_like(a), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    G = torch.empty((B, nc, l, l), dtype=torch.float32, device=dev)
    dG_parts = torch.empty((B, nc, -(-H // HEAD_GROUP), l, l), dtype=torch.float32, device=dev)
    dG = torch.empty((B, nc, l, l), dtype=torch.float32, device=dev)
    e = torch.empty((B, nc, H, l), dtype=torch.float32, device=dev)
    status = lib.ssd_chunk_bwd_launch(
        a.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(), dS.data_ptr(),
        dtot.data_ptr(), da.data_ptr(), dx.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        G.data_ptr(), dG_parts.data_ptr(), dG.data_ptr(), e.data_ptr(), B, nc, l, H, P, N,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "ssd_chunk_intra_bwd")
    bwd_launches += 1
    return da, dx, dB, dC
