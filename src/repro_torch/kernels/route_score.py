"""The WAN route-score pass: plain PyTorch version and CUDA wrapper.

Counterpart of `repro.kernels.route_score.route_scores` (Pallas) and of
its oracle `repro.kernels.ref.route_scores_ref`:

  rc[m,l] = VCt[l]*pt[m,l] + extra[m,l] + Qt[m,l] + Qcr[m,l]
  l1[m]   = argmin_l rc[m,l]                  (first index on ties)
  b[m]    = V*Ce*pe[m] + min_l rc[m,l] - Qe[m]

with Qcr = Qc[:, dest]. Rounding is the contract, in two modes:
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
    """-> (rc [M,L] f32, l1 [M] int32, b [M] f32), on the inputs' device."""
    Qt = Qt.float()
    V_Ce = torch.as_tensor(V_Ce, dtype=torch.float32, device=Qt.device)
    if extra is None:
        rc = fma_f32(VCt.float()[None, :], pt.float(), Qt) + Qcr.float()
    else:
        rc = (fma_f32(VCt.float()[None, :], pt.float(), extra.float()) + Qt) + Qcr.float()
    l1 = torch.argmin(rc, dim=1).to(torch.int32)
    rmin = torch.amin(rc, dim=1)
    b = fma_f32(V_Ce, pe.float(), rmin) - Qe.float()
    return rc, l1, b


def _lib():
    lib = build.load("route_score")
    if lib.route_scores_launch.argtypes is None:
        lib.route_scores_launch.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [
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
    mode without `extra` when it is None. `V_Ce` is a 0-d (or
    one-element) float32 tensor on the device, so the launch needs no
    host read of device data."""
    global launches
    M, L = Qt.shape
    if M < 1 or L < 1:
        raise ValueError(f"route_scores: empty problem M={M}, L={L}")
    dev = Qt.device
    for name, x in (("Qt", Qt), ("pt", pt), ("Qcr", Qcr)):
        _check_f32(name, x, (M, L), dev)
    if extra is not None:
        _check_f32("extra", extra, (M, L), dev)
        extra = extra.contiguous()
    _check_f32("Qe", Qe, (M,), dev)
    _check_f32("pe", pe, (M,), dev)
    _check_f32("VCt", VCt, (L,), dev)
    _check_f32("V_Ce", V_Ce.reshape(()), (), dev)
    Qt, pt, Qcr, Qe, pe, VCt, V_Ce = (x.contiguous() for x in (Qt, pt, Qcr, Qe, pe, VCt, V_Ce))
    rc = torch.empty((M, L), dtype=torch.float32, device=dev)
    l1 = torch.empty((M,), dtype=torch.int32, device=dev)
    b = torch.empty((M,), dtype=torch.float32, device=dev)
    lib = _lib()
    status = lib.route_scores_launch(
        Qt.data_ptr(), pt.data_ptr(), Qcr.data_ptr(),
        extra.data_ptr() if extra is not None else None, Qe.data_ptr(), pe.data_ptr(),
        VCt.data_ptr(), V_Ce.data_ptr(), rc.data_ptr(), l1.data_ptr(), b.data_ptr(), M, L,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "route_scores")
    launches += 1
    return rc, l1, b
