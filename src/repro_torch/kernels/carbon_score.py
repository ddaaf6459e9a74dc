"""The DPP score pass: plain PyTorch version and CUDA wrapper.

Counterpart of `repro.kernels.carbon_score.carbon_scores` (Pallas) and of
its oracle `repro.kernels.ref.carbon_scores_ref`:

  c[m,n] = VCc[n]*pc[m,n] - Qc[m,n]
  n1[m]  = argmin_n Qc[m,n]                 (first index on ties)
  b[m]   = V*Ce*pe[m] + min_n Qc[m,n] - Qe[m]

with a leading lane axis, as the Pallas kernel takes one under `vmap`
(`simulate_fleet`, `simulate_vsweep`): Qc/pc [F, M, N], Qe/pe [F, M], VCc
[F, N] and V_Ce [F] (one V*Ce per lane). The [M, N] call is F = 1.

Rounding is the contract: under `jit` XLA:CPU computes `c` as
fmaf(VCc, pc, -Qc) and `b` as fmaf(V*Ce, pe, qmin) - Qe, so both versions
here round exactly so. The kernel lives in `csrc/carbon_score.cu`; its
source note gives its bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.numerics import fma_f32

# Launches of the CUDA kernel in this process (read by chip_smoke.py).
launches = 0


def carbon_scores_plain(Qc, pc, Qe, pe, VCc, V_Ce):
    """-> (c [..., M, N] f32, n1 [..., M] int32, b [..., M] f32), on the
    inputs' device."""
    Qc = Qc.float()
    V_Ce = torch.as_tensor(V_Ce, dtype=torch.float32, device=Qc.device)
    c = fma_f32(VCc.float()[..., None, :], pc.float(), -Qc)
    n1 = torch.argmin(Qc, dim=-1).to(torch.int32)
    qmin = torch.amin(Qc, dim=-1)
    b = fma_f32(V_Ce[..., None], pe.float(), qmin) - Qe.float()
    return c, n1, b


def _lib():
    lib = build.load("carbon_score")
    if lib.carbon_scores_launch.argtypes is None:
        lib.carbon_scores_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        lib.carbon_scores_launch.restype = ctypes.c_int
    return lib


def _check_f32(name, x, shape, device):
    if x.dtype != torch.float32 or x.device != device or tuple(x.shape) != shape:
        raise ValueError(
            f"carbon_scores: {name} must be float32 {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )


def carbon_scores_cuda(Qc, pc, Qe, pe, VCc, V_Ce):
    """Launches csrc/carbon_score.cu on PyTorch's current stream. Qc is
    [M, N] or [F, M, N]; VCc ([N] or [F, N]) and V_Ce (one value, or one
    a lane) are float32 tensors on the device, broadcast to the lanes, so
    the launch needs no host read of device data."""
    global launches
    if Qc.dim() not in (2, 3):
        raise ValueError(f"carbon_scores: Qc must be [M, N] or [F, M, N], got {tuple(Qc.shape)}")
    lead, (M, N) = tuple(Qc.shape[:-2]), Qc.shape[-2:]
    F = lead[0] if lead else 1
    if M < 1 or N < 1 or F < 1:
        raise ValueError(f"carbon_scores: empty problem F={F}, M={M}, N={N}")
    dev = Qc.device
    _check_f32("Qc", Qc, lead + (M, N), dev)
    _check_f32("pc", pc, lead + (M, N), dev)
    _check_f32("Qe", Qe, lead + (M,), dev)
    _check_f32("pe", pe, lead + (M,), dev)
    if lead:  # one V*Cc row and one V*Ce a lane (a single lane takes them as they are)
        VCc = torch.broadcast_to(VCc, lead + (N,))
        V_Ce = torch.broadcast_to(V_Ce, lead)
    else:
        V_Ce = V_Ce.reshape(())
    _check_f32("VCc", VCc, lead + (N,), dev)
    _check_f32("V_Ce", V_Ce, lead, dev)
    Qc, pc, Qe, pe, VCc, V_Ce = (x.contiguous() for x in (Qc, pc, Qe, pe, VCc, V_Ce))
    c = torch.empty(lead + (M, N), dtype=torch.float32, device=dev)
    n1 = torch.empty(lead + (M,), dtype=torch.int32, device=dev)
    b = torch.empty(lead + (M,), dtype=torch.float32, device=dev)
    lib = _lib()
    status = lib.carbon_scores_launch(
        Qc.data_ptr(), pc.data_ptr(), Qe.data_ptr(), pe.data_ptr(), VCc.data_ptr(),
        V_Ce.data_ptr(), c.data_ptr(), n1.data_ptr(), b.data_ptr(), F, M, N,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "carbon_scores")
    launches += 1
    return c, n1, b
