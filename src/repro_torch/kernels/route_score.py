"""The WAN route-score pass: plain PyTorch version and CUDA wrapper.

Counterpart of `repro.kernels.route_score.route_scores` (Pallas) and of
its oracle `repro.kernels.ref.route_scores_ref`:

  rc[m,l] = VCt[l]*pt[m,l] + extra[m,l] + Qt[m,l] + Qcr[m,l]
  l1[m]   = argmin_l rc[m,l]                  (first index on ties)
  b[m]    = V*Ce*pe[m] + min_l rc[m,l] - Qe[m]

with Qcr = Qc[:, dest], and a leading lane axis, as the Pallas kernel
takes one under `vmap` (the WAN fleet): Qt/pt/Qcr/extra [F, M, L], Qe/pe
[F, M], VCt [F, L] and V_Ce [F] (one V*Ce per lane). The [M, L] call is
F = 1. Rounding is the contract, in two modes:
`extra` given, rc = (fma(VCt, pt, extra) + Qt) + Qcr, which is what
`jit(route_scores_ref)` and the Pallas kernel compute; `extra=None` (the
policy's default route_compute_weight 0), rc = fma(VCt, pt, Qt) + Qcr,
which is what the JAX policy computes inside its scan, where XLA folds
the zero `extra` and contracts the next add. In both, b = fma(V*Ce, pe,
min rc) - Qe. The kernel lives in `csrc/route_score.cu`; its source note
gives its bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.numerics import fma_f32

# Launches of the CUDA kernel in this process (read by chip_smoke.py).
launches = 0


def route_scores_plain(Qt, pt, Qcr, extra, Qe, pe, VCt, V_Ce):
    """-> (rc [..., M, L] f32, l1 [..., M] int32, b [..., M] f32), on
    the inputs' device."""
    Qt = Qt.float()
    V_Ce = torch.as_tensor(V_Ce, dtype=torch.float32, device=Qt.device)
    vct = VCt.float()[..., None, :]
    if extra is None:
        rc = fma_f32(vct, pt.float(), Qt) + Qcr.float()
    else:
        rc = (fma_f32(vct, pt.float(), extra.float()) + Qt) + Qcr.float()
    l1 = torch.argmin(rc, dim=-1).to(torch.int32)
    rmin = torch.amin(rc, dim=-1)
    b = fma_f32(V_Ce[..., None], pe.float(), rmin) - Qe.float()
    return rc, l1, b


def _lib():
    lib = build.load("route_score")
    if lib.route_scores_launch.argtypes is None:
        lib.route_scores_launch.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        lib.route_scores_launch.restype = ctypes.c_int
    return lib


def _check_f32(name, x, shape, device):
    if x.dtype != torch.float32 or x.device != device or tuple(x.shape) != shape:
        raise ValueError(
            f"route_scores: {name} must be float32 {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )


def route_scores_cuda(Qt, pt, Qcr, extra, Qe, pe, VCt, V_Ce):
    """Launches csrc/route_score.cu on PyTorch's current stream, in the
    mode without `extra` when it is None. Qt is [M, L] or [F, M, L];
    VCt ([L] or [F, L]) and V_Ce (one value, or one a lane) are float32
    tensors on the device, broadcast to the lanes, so the launch needs
    no host read of device data."""
    global launches
    if Qt.dim() not in (2, 3):
        raise ValueError(f"route_scores: Qt must be [M, L] or [F, M, L], got {tuple(Qt.shape)}")
    lead, (M, L) = tuple(Qt.shape[:-2]), Qt.shape[-2:]
    F = lead[0] if lead else 1
    if M < 1 or L < 1 or F < 1:
        raise ValueError(f"route_scores: empty problem F={F}, M={M}, L={L}")
    dev = Qt.device
    for name, x in (("Qt", Qt), ("pt", pt), ("Qcr", Qcr)):
        _check_f32(name, x, lead + (M, L), dev)
    if extra is not None:
        _check_f32("extra", extra, lead + (M, L), dev)
        extra = extra.contiguous()
    _check_f32("Qe", Qe, lead + (M,), dev)
    _check_f32("pe", pe, lead + (M,), dev)
    if lead:  # one V*Ct row and one V*Ce a lane (a single lane takes them as they are)
        VCt = torch.broadcast_to(VCt, lead + (L,))
        V_Ce = torch.broadcast_to(V_Ce, lead)
    else:
        V_Ce = V_Ce.reshape(())
    _check_f32("VCt", VCt, lead + (L,), dev)
    _check_f32("V_Ce", V_Ce, lead, dev)
    Qt, pt, Qcr, Qe, pe, VCt, V_Ce = (x.contiguous() for x in (Qt, pt, Qcr, Qe, pe, VCt, V_Ce))
    rc = torch.empty(lead + (M, L), dtype=torch.float32, device=dev)
    l1 = torch.empty(lead + (M,), dtype=torch.int32, device=dev)
    b = torch.empty(lead + (M,), dtype=torch.float32, device=dev)
    lib = _lib()
    status = lib.route_scores_launch(
        Qt.data_ptr(), pt.data_ptr(), Qcr.data_ptr(),
        extra.data_ptr() if extra is not None else None, Qe.data_ptr(), pe.data_ptr(),
        VCt.data_ptr(), V_Ce.data_ptr(), rc.data_ptr(), l1.data_ptr(), b.data_ptr(), F, M, L,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "route_scores")
    launches += 1
    return rc, l1, b
