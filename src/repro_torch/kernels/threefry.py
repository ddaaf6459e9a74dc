"""One threefry draw per launch: plain PyTorch version and CUDA wrapper.

A draw takes base keys [F, 2] (int64 holding uint32 pairs, see
`repro_torch.random`) and an optional slot `t`, and writes [F, n]:

  k = fold_in(keys, t)                  (when t is given)
  seg:       split(k) into two halves; values 0..seg-1 from the first
             (counters 0..), the rest from the second (counters 0..)
  fold_each: value j from fold_in(k, j), counter 0
  chain=(R, C): [F, R, C, n], round r's draw c from child c + 1 of k_r,
             k_0 = k, k_{r+1} = child 0 of k_r (child i of a key is
             split(k, *)[i]): the key walk of `random.poisson`'s loops,
             every round in one draw ("bits" and "uniform" only)
  finish:    "bits" (int64), "uniform" (float32 on [minval, maxval)),
             "floor" (floor(uniform * scale), float32; the fleet's
             arrivals), "randint" (int32) or "randint_f32" (its float32)

The plain version is that composition of `repro_torch.random`'s
functions; the kernel (`csrc/threefry.cu`, whose note gives its bound and
design) computes every element's key chain itself, so a slot's draw is
one launch with `t` an argument: no host work, no host-to-device copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import random as R
from repro_torch.kernels import build

# Launches of the CUDA kernel in this process (read by chip_smoke.py).
launches = 0

FINISHES = ("bits", "uniform", "floor", "randint", "randint_f32")


def _check(n, finish, seg, fold_each, chain):
    if finish not in FINISHES:
        raise ValueError(f"threefry_draw: finish {finish!r} is not one of {FINISHES}")
    if n < 1:
        raise ValueError(f"threefry_draw: n={n} must be >= 1")
    if seg is not None and (fold_each or not 0 <= seg <= n):
        raise ValueError(f"threefry_draw: seg={seg} must lie in [0, n={n}] without fold_each")
    if chain is not None:
        rounds, children = chain
        if rounds < 1 or children < 1 or seg is not None or fold_each or finish not in (
                "bits", "uniform"):
            raise ValueError(f"threefry_draw: chain={chain} needs R, C >= 1, no seg or "
                             "fold_each, and the finish 'bits' or 'uniform'")


def _finish(key, n, finish, minval, maxval, scale):
    if finish == "bits":
        return R.random_bits(key, (n,))
    if finish == "uniform":
        return R.uniform(key, (n,), minval, maxval)
    if finish == "floor":
        return torch.floor(R.uniform(key, (n,)) * scale)
    out = R.randint(key, (n,), minval, maxval)
    return out.float() if finish == "randint_f32" else out


def threefry_draw_plain(keys, t, n, *, finish="uniform", seg=None, fold_each=False,
                        chain=None, minval=0, maxval=1, scale=None):
    """-> [*keys.shape[:-1], n] ([..., R, C, n] with a chain), on the
    keys' device."""
    _check(n, finish, seg, fold_each, chain)
    k = keys if t is None else R.fold_in(keys, t)
    if chain is not None:
        rounds, children = chain
        out = []
        for _ in range(rounds):
            kids = R.split(k, children + 1)
            out.append(torch.stack([_finish(kids[..., c, :], n, finish, minval, maxval, None)
                                    for c in range(1, children + 1)], dim=-2))
            k = kids[..., 0, :]
        return torch.stack(out, dim=-3)
    if seg is not None:
        halves = R.split(k, 2)
        lead = scale if scale is None else scale[..., :seg]
        rest = scale if scale is None else scale[..., seg:]
        parts = [_finish(halves[..., 0, :], seg, finish, minval, maxval, lead),
                 _finish(halves[..., 1, :], n - seg, finish, minval, maxval, rest)]
        return torch.cat(parts, dim=-1)
    if fold_each:
        kj = R.fold_in(k[..., None, :], torch.arange(n, device=k.device))
        return _finish(kj, 1, finish, minval, maxval,
                       None if scale is None else scale[..., None])[..., 0]
    return _finish(k, n, finish, minval, maxval, scale)


def _lib():
    lib = build.load("threefry")
    if lib.threefry_draw_launch.argtypes is None:
        c = ctypes
        lib.threefry_draw_launch.argtypes = [
            c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_uint, c.c_int, c.c_int, c.c_int,
            c.c_int, c.c_int, c.c_float, c.c_float, c.c_int, c.c_ulonglong, c.c_ulonglong,
            c.c_void_p, c.c_int, c.c_void_p, c.c_void_p]
        lib.threefry_draw_launch.restype = ctypes.c_int
    return lib


_OUT_DTYPE = {"bits": torch.int64, "uniform": torch.float32, "floor": torch.float32,
              "randint": torch.int32, "randint_f32": torch.float32}
_FINISH_CODE = {"bits": 0, "uniform": 1, "floor": 2, "randint": 3, "randint_f32": 4}


def threefry_draw_cuda(keys, t, n, *, finish="uniform", seg=None, fold_each=False,
                       chain=None, minval=0, maxval=1, scale=None):
    """Launches csrc/threefry.cu on PyTorch's current stream. `t` and
    the bounds are host ints and floats; the keys and `scale` live on
    the device."""
    global launches
    _check(n, finish, seg, fold_each, chain)
    dev = keys.device
    if keys.dtype != torch.int64 or keys.shape[-1] != 2:
        raise ValueError(f"threefry_draw: keys must be int64 [..., 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    lead = tuple(keys.shape[:-1])
    F = 1
    for s in lead:
        F *= s
    if F < 1:
        raise ValueError("threefry_draw: no keys")
    keys = keys.contiguous()
    span = mult = 1
    mn = 0
    if finish in ("randint", "randint_f32"):
        mn, span, mult = R.randint_span(minval, maxval)
    scale_per_lane = 0
    if finish == "floor":
        if scale is None or scale.dtype != torch.float32 or scale.device != dev:
            raise ValueError(f"threefry_draw: finish 'floor' needs a float32 scale on {dev}")
        if tuple(scale.shape) == lead + (n,):
            scale_per_lane = 1
        elif tuple(scale.shape) != (n,):
            raise ValueError(f"threefry_draw: scale {tuple(scale.shape)} is neither "
                             f"{lead + (n,)} nor ({n},)")
        scale = scale.contiguous()
    rounds, children = (0, 1) if chain is None else (int(chain[0]), int(chain[1]))
    inner = (n,) if chain is None else (rounds, children, n)
    out = torch.empty(lead + inner, dtype=_OUT_DTYPE[finish], device=dev)
    lib = _lib()
    status = lib.threefry_draw_launch(
        keys.data_ptr(), F, n, int(t is not None), 0 if t is None else int(t) & R.M32,
        -1 if seg is None else int(seg), int(bool(fold_each)), rounds, children,
        _FINISH_CODE[finish],
        float(minval), float(maxval), int(mn), int(span), int(mult),
        scale.data_ptr() if scale is not None else None, scale_per_lane, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "threefry_draw")
    launches += 1
    return out
