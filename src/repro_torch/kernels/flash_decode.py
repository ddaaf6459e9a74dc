"""Single-query attention over a KV cache: plain PyTorch version and CUDA
wrapper.

Counterpart of `repro.kernels.flash_decode.flash_decode` (Pallas) and of
its oracle `repro.kernels.ref.flash_decode_ref`, with their layout: q
[B,H,hd], k/v [B,S,K,hd], `pos` the last valid cache index (inclusive),
G = H/K query heads per kv head (head h reads kv head h // G). Scores,
softmax and the output sum are float32; the output has q's dtype; a
rejected position scores -1e30. The kernel lives in
`csrc/flash_decode.cu` (hd 16, 32, 64, 128 and 256, as flash_attention's
HEAD_DIMS); its source note gives its bound and design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS, NEG_INF

MAX_GROUP = 32  # queries per kv head the kernel takes

# Launches of the CUDA kernel (bf16: one kernel; float32: split + combine)
# in this process.
launches = 0


def flash_decode_plain(q, k, v, pos):
    """-> [B,H,hd] in q's dtype, attending over cache[:, :pos+1]. `pos`
    may be a 0-d tensor on the inputs' device (read there, no sync)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"flash_decode: H={H} is not a multiple of K={K}")
    G = H // K
    qf = q.reshape(B, K, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def _lib():
    lib = build.load("flash_decode")
    if lib.flash_decode_launch.argtypes is None:
        lib.flash_decode_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_decode_launch.restype = ctypes.c_int
        lib.flash_decode_scratch.argtypes = [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
        lib.flash_decode_scratch.restype = ctypes.c_int
    return lib


_SCRATCH: dict = {}  # (dtype code, B, S, K, G, hd, device) -> (floats, tickets)
_TICKETS: dict = {}  # device -> zeroed int32 tickets, grown by doubling
_RETIRED: list = []  # outgrown ticket buffers, kept alive for captured graphs


def _scratch_sizes(lib, key):
    sizes = _SCRATCH.get(key)
    if sizes is None:
        floats, tickets = ctypes.c_longlong(), ctypes.c_int()
        build.check(lib, lib.flash_decode_scratch(*key[:6], ctypes.byref(floats),
                                                  ctypes.byref(tickets)), "flash_decode")
        sizes = _SCRATCH[key] = (floats.value, tickets.value)
    return sizes


def _tickets(dev, n):
    """The device's zeroed ticket counters: each launch leaves them zero."""
    buf = _TICKETS.get(dev)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = _TICKETS[dev] = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel()), 1024),
                                          dtype=torch.int32, device=dev)
    return buf


def flash_decode_cuda(q, k, v, pos):
    """Launches csrc/flash_decode.cu on PyTorch's current stream: bf16 on
    the tensor cores in one launch (splits of the cache, the last block
    of each group combining them), float32 on the CUDA cores (split and
    combine). `pos` is an int32 tensor of one element on the device: the
    kernels read it there, so a decode loop never waits for the host. The
    partial softmax state lives in one float32 scratch tensor a call;
    the combine's tickets in a zeroed buffer kept per device."""
    global launches
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_decode: dtype {q.dtype}; the kernel takes float32 or bfloat16")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != dev or tuple(x.shape) != (B, S, K, hd):
            raise ValueError(f"flash_decode: {name} must be {q.dtype} {(B, S, K, hd)} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be contiguous and 16-byte aligned")
    if not (torch.is_tensor(pos) and pos.dtype == torch.int32 and pos.device == dev
            and pos.numel() == 1):
        raise ValueError("flash_decode: pos must be a one-element int32 tensor on the device")
    if hd not in HEAD_DIMS or H % K or not 1 <= H // K <= MAX_GROUP or S < 1:
        raise ValueError(f"flash_decode: unsupported shape H={H} K={K} S={S} hd={hd} (hd one "
                         f"of {HEAD_DIMS}, 1 <= H/K <= {MAX_GROUP})")
    G = H // K
    q = q.contiguous()
    lib = _lib()
    code = 0 if q.dtype == torch.float32 else 1
    floats, n_tickets = _scratch_sizes(lib, (code, B, S, K, G, hd, dev))
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    tickets = _tickets(dev, n_tickets)
    out = torch.empty_like(q)
    status = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), tickets.data_ptr(), code, B, S, K, G, hd, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "flash_decode")
    launches += 1
    return out
