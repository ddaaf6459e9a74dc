"""GQA flash-attention forward: plain PyTorch version and CUDA wrapper.

Counterpart of `repro.kernels.flash_attention.flash_attention` (Pallas)
and of its oracle `repro.kernels.ref.flash_attention_ref`, with their
layout: q [B,H,Sq,hd], k/v [B,K,Skv,hd], query head h reading kv head
h*K//H; masks causal (k_pos <= q_pos), prefix (causal, or k_pos <
prefix_len) and full, positions counted from 0. Scores, softmax and the
output sum are float32; the output has q's dtype. A rejected score is
-1e30 (the kernels' mask value; the JAX model uses finfo(f32).min / 2,
and both give weight exactly 0 beside one valid key). The kernels live in
`csrc/flash_attention.cu`: bf16 inputs run on the tensor cores (wgmma,
TMA), float32 inputs on the CUDA cores, at hd 16, 32, 64, 128 and 256
(any other hd raises ValueError before a build); its source note gives
the bound and the design.

The backward, `flash_attention_bwd_plain` and `flash_attention_bwd_cuda`
(`csrc/flash_attention_bwd.cu`), is the gradient of exactly the function
`flash_attention_plain` computes, as XLA differentiates the JAX model's
`attention_scores_chunked` (the JAX package has no backward kernel): from
q, k, v and the output's gradient dO it recomputes P, then dP = dO.V^T,
D = rowsum(P*dP), dS = P*(dP - D), dq = scale*dS.K, dk = dS^T.(scale*q)
(summed over the G query heads of a kv head), dv = P^T.dO, all float32,
each gradient rounded once to its input's dtype. D is never FA2's
rowsum(dO*O) over the rounded output: in bf16 that form adds O's
rounding to dS (tests/test_torch_attention_grad.py emulates both). The
float32 kernel recomputes every row's statistics. The bf16 kernel (tensor
cores) takes two from the forward: `flash_attention_cuda(..., stats=True)`
also returns each row's log-sum-exp (log2 domain) and the float32 output
before rounding, O32, whose rowsum(dO*O32) is rowsum(P*dP) in another
order. hd 16-128; hd 256 raises ValueError. `ops.flash_attention` wraps
forward and backward in one autograd Function, and asks the forward for
those statistics only when an input needs a gradient.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MODES = {"causal": 0, "prefix": 1, "full": 2}
HEAD_DIMS = (16, 32, 64, 128, 256)  # both routes; hd 256 has its own instances
QUERY_CHUNK = 512  # rows per score block of the plain version

BWD_HEAD_DIMS = (16, 32, 64, 128)  # the backward kernel's instances

# Launches of the CUDA kernels in this process (read by chip_smoke.py):
# the forward, and the backward (one a call: its three passes).
launches = 0
bwd_launches = 0


def _check_mode(mask_mode):
    if mask_mode not in MODES:
        raise ValueError(f"flash_attention: mask_mode {mask_mode!r} is not one of {tuple(MODES)}")


def flash_attention_plain(q, k, v, *, mask_mode="causal", prefix_len=0):
    """-> [B,H,Sq,hd] in q's dtype. Exact attention computed in query
    chunks of QUERY_CHUNK rows (the peak is one [B,K,G,chunk,Skv]
    float32 score block); chunking changes no row's arithmetic."""
    _check_mode(mask_mode)
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"flash_attention: H={H} is not a multiple of K={K}")
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(Skv, device=q.device)
    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    for s0 in range(0, Sq, QUERY_CHUNK):
        c = min(QUERY_CHUNK, Sq - s0)
        qg = (q[:, :, s0:s0 + c].float() * scale).reshape(B, K, G, c, hd)
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf)
        if mask_mode != "full":
            q_pos = torch.arange(s0, s0 + c, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            if mask_mode == "prefix":
                mask = mask | (k_pos[None, :] < prefix_len)
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        y = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
        out[:, :, s0:s0 + c] = y.reshape(B, H, c, hd).to(q.dtype)
    return out


def flash_attention_bwd_plain(q, k, v, dout, *, mask_mode="causal", prefix_len=0):
    """-> (dq, dk, dv) in the dtypes of q, k, v: the gradient of
    `flash_attention_plain(q, k, v)` against dout [B,H,Sq,hd], in query
    chunks of QUERY_CHUNK rows (dk and dv summed chunk after chunk in
    float32). The scores, softmax and masks are the forward's, so P is
    the forward's P bit for bit."""
    _check_mode(mask_mode)
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"flash_attention_bwd: H={H} is not a multiple of K={K}")
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(Skv, device=q.device)
    dq = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    dk = torch.zeros((B, K, Skv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for s0 in range(0, Sq, QUERY_CHUNK):
        c = min(QUERY_CHUNK, Sq - s0)
        qg = (q[:, :, s0:s0 + c].float() * scale).reshape(B, K, G, c, hd)
        g = dout[:, :, s0:s0 + c].float().reshape(B, K, G, c, hd)
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf)
        if mask_mode != "full":
            q_pos = torch.arange(s0, s0 + c, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            if mask_mode == "prefix":
                mask = mask | (k_pos[None, :] < prefix_len)
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        dp = torch.einsum("bkgqd,bksd->bkgqs", g, vf)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        dq[:, :, s0:s0 + c] = (torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale).reshape(
            B, H, c, hd).to(q.dtype)
        dk += torch.einsum("bkgqs,bkgqd->bksd", ds, qg)
        dv += torch.einsum("bkgqs,bkgqd->bksd", p, g)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    lib = build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _kernel_strides(x):
    """x's [b, h, s] strides in elements, each of an extent-1 dimension
    replaced by the packed value (its index is always 0, and TMA wants
    every stride a multiple of 16 bytes)."""
    out, packed = [], x.shape[-1]
    for dim in (2, 1, 0):  # s, h, b
        out.append(x.stride(dim) if x.shape[dim] > 1 else packed)
        packed = out[-1] * x.shape[dim]
    return out[::-1]


def _check_tma(name, x):
    """The bf16 kernel loads q, k, v with TMA, which takes a base aligned
    to 16 bytes and strides that are multiples of 16 bytes. A view that
    breaks either is refused; it is not copied and not routed elsewhere."""
    nbytes = x.element_size()
    strides = [st * nbytes for st in _kernel_strides(x)]
    if x.data_ptr() % 16 or any(st % 16 for st in strides):
        raise ValueError(f"flash_attention: TMA needs {name} with a 16-byte aligned base and "
                         f"[b, h, s] strides that are multiples of 16 bytes; got base offset "
                         f"{x.data_ptr() % 16} and strides {strides} bytes")


def _row_stats(B, H, Sq, dev):
    """A float32 [B, H, Sq] of per-row statistics whose rows are padded
    to a multiple of 4 floats, so TMA can load it (16-byte strides)."""
    return torch.empty((B, H, -(-Sq // 4) * 4), dtype=torch.float32, device=dev)[..., :Sq]


def flash_attention_cuda(q, k, v, *, mask_mode="causal", prefix_len=0, stats=False):
    """Launches csrc/flash_attention.cu on PyTorch's current stream: bf16
    on the tensor cores, float32 on the CUDA cores. q, k, v may be strided
    views (the head dimension contiguous), such as the model's [B,S,H,hd]
    projections transposed; for bf16 their bases and strides must be
    16-byte multiples (`_check_tma`). The output takes q's layout when q
    is dense, so the caller's transpose back is free. With `stats` (bf16,
    hd 16-128: what the bf16 backward reads) -> (out, lse [B,H,Sq], o32
    [B,H,Sq,hd]), both float32: each row's log-sum-exp in the log2 domain
    of the kernel's exponent (m*c + log2(l), c = log2(e)/sqrt(hd)) and the
    output before its rounding to bf16; `out` is bitwise the same."""
    global launches
    _check_mode(mask_mode)
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtype {q.dtype}; the kernel takes float32 or bfloat16")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != dev or tuple(x.shape) != (B, K, Skv, hd):
            raise ValueError(f"flash_attention: {name} must be {q.dtype} {(B, K, Skv, hd)} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if hd not in HEAD_DIMS or H % K or Sq < 1 or Skv < 1:
        raise ValueError(f"flash_attention: unsupported shape H={H} K={K} Sq={Sq} Skv={Skv} "
                         f"hd={hd} (hd one of {HEAD_DIMS}, H a multiple of K)")
    if stats and (q.dtype != torch.bfloat16 or hd not in BWD_HEAD_DIMS):
        raise ValueError(f"flash_attention: stats are the bf16 backward's, which takes bfloat16 "
                         f"at hd {BWD_HEAD_DIMS}; got {q.dtype} at hd {hd}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, x)
    out = torch.empty_like(q)
    lse = _row_stats(B, H, Sq, dev) if stats else None
    o32 = torch.empty((B, H, Sq, hd), dtype=torch.float32, device=dev) if stats else None
    strides = (ctypes.c_longlong * 14)(
        *(s for x in (q, k, v, out) for s in _kernel_strides(x)),
        *((lse.stride(0), lse.stride(1)) if stats else (0, 0)))
    lib = _lib()
    status = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if stats else None, o32.data_ptr() if stats else None,
        0 if q.dtype == torch.float32 else 1, B, H, K, Sq, Skv, hd, strides, MODES[mask_mode],
        int(prefix_len), 1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "flash_attention")
    launches += 1
    return (out, lse, o32) if stats else out


def _check_stats(lse, o32, shape, dev):
    """lse [B,H,Sq] with its rows 16-byte aligned (TMA loads it by query
    tiles) and o32 [B,H,Sq,hd] contiguous, both float32 on dev."""
    B, H, Sq, hd = shape
    ok = (lse.dtype == o32.dtype == torch.float32 and lse.device == o32.device == dev
          and tuple(lse.shape) == (B, H, Sq) and tuple(o32.shape) == shape
          and o32.is_contiguous() and lse.stride(2) == 1 and lse.data_ptr() % 16 == 0
          and lse.stride(0) % 4 == 0 and lse.stride(1) % 4 == 0)
    if not ok:
        raise ValueError(f"flash_attention_bwd: lse must be float32 {(B, H, Sq)} with 16-byte "
                         f"aligned rows and o32 float32 {shape} contiguous on {dev} (as "
                         f"flash_attention_cuda(..., stats=True) makes them); got {lse.dtype} "
                         f"{tuple(lse.shape)} strides {lse.stride()} and {o32.dtype} "
                         f"{tuple(o32.shape)}")


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    if lib.flash_attention_bwd_launch.argtypes is None:
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p])
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
    return lib


def flash_attention_bwd_cuda(q, k, v, dout, *, mask_mode="causal", prefix_len=0, lse=None,
                             o32=None):
    """Launches csrc/flash_attention_bwd.cu on PyTorch's current stream,
    at hd 16-128. bf16 (tensor cores) takes the forward's statistics,
    `lse` and `o32` from `flash_attention_cuda(q, k, v, stats=True)` with
    the same mask: D = rowsum(dO*O32), a key pass (dk, dv) and a query
    pass (dq); q, k, v and dout go through TMA (`_check_tma`). float32
    (CUDA cores) takes neither and recomputes them: row statistics, dk/dv
    by key blocks, dq by query blocks. q, k, v and dout may be strided
    views with the head dimension contiguous (another layout is copied
    with .contiguous()); dq, dk, dv take the layouts of q, k, v. No
    atomics: two calls give the same bits."""
    global bwd_launches
    _check_mode(mask_mode)
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_bwd: dtype {q.dtype}; the kernel takes float32 or "
                         "bfloat16")
    for name, x, shape in (("k", k, (B, K, Skv, hd)), ("v", v, (B, K, Skv, hd)),
                           ("dout", dout, (B, H, Sq, hd))):
        if x.dtype != q.dtype or x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f"flash_attention_bwd: {name} must be {q.dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if hd not in BWD_HEAD_DIMS or H % K or Sq < 1 or Skv < 1:
        raise ValueError(f"flash_attention_bwd: unsupported shape H={H} K={K} Sq={Sq} Skv={Skv} "
                         f"hd={hd} (hd one of {BWD_HEAD_DIMS}, H a multiple of K)")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        if lse is None or o32 is None:
            raise ValueError("flash_attention_bwd: the bf16 kernel takes the forward's lse and o32 "
                             "(flash_attention_cuda(q, k, v, stats=True))")
        _check_stats(lse, o32, (B, H, Sq, hd), dev)
    elif lse is not None or o32 is not None:
        raise ValueError("flash_attention_bwd: the float32 kernel takes no lse or o32")
    q, k, v, dout = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v, dout))
    if bf16:
        for name, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            _check_tma(name, x)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if bf16:
        stats, delta = None, _row_stats(B, H, Sq, dev)  # D
        rows = (lse.stride(0), lse.stride(1), delta.stride(0), delta.stride(1))
    else:
        stats, delta = torch.empty((3, B, H, Sq), dtype=torch.float32, device=dev), None
        rows = (0, 0, 0, 0)  # max, 1/sum, D in stats
    strides = (ctypes.c_longlong * 25)(*(s for x in (q, k, v, dout, dq, dk, dv)
                                         for s in _kernel_strides(x)), *rows)
    lib = _bwd_lib()
    status = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if bf16 else stats.data_ptr(), lse.data_ptr() if bf16 else None,
        o32.data_ptr() if bf16 else None, delta.data_ptr() if bf16 else None, int(bf16), B, H,
        K, Sq, Skv, hd, strides, MODES[mask_mode], int(prefix_len), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
