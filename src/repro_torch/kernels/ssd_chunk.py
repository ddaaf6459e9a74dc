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
        lib.ssd_chunk_bwd_launch.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.ssd_chunk_bwd_launch.restype = ctypes.c_int
    return lib


def ssd_chunk_intra_bwd_cuda(a, x, Bm, Cm, dy, dS, dtot):
    """Launches csrc/ssd_chunk_bwd.cu on PyTorch's current stream: the
    backward of `ssd_chunk_intra_cuda` -> (da, dx, dB, dC). Takes the
    forward's shapes plus dy [B,nc,l,H,P], dS [B,nc,H,N,P], dtot
    [B,nc,H], all contiguous float32 on one CUDA device, and raises on
    anything else (before any build). Scratch (the scores, their
    gradient, ci) comes from torch.empty."""
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
    dG = torch.empty((B, nc, l, l), dtype=torch.float32, device=dev)
    ci = torch.empty((B, nc, H, l), dtype=torch.float32, device=dev)
    status = lib.ssd_chunk_bwd_launch(
        a.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(), dS.data_ptr(),
        dtot.data_ptr(), da.data_ptr(), dx.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        G.data_ptr(), dG.data_ptr(), ci.data_ptr(), B, nc, l, H, P, N,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "ssd_chunk_intra_bwd")
    bwd_launches += 1
    return da, dx, dB, dC
