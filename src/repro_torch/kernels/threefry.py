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
  paths:     ((path, length), ...): the n = sum(lengths) values are
             segments, each from the key reached from k by `path`, a
             tuple of split-child indices (child i of a key is
             split(k, *)[i], whatever the split's width), counters 0..
             in each segment ("uniform" only; up to 8 segments of paths
             up to 4 deep): the fault stream's six uniforms a slot, each
             from its own key, in one draw
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

# Launches of the CUDA kernel in this process (read by chip_smoke.py);
# `path_launches` counts those of them that drew `paths=`.
launches = 0
path_launches = 0

FINISHES = ("bits", "uniform", "floor", "randint", "randint_f32")


MAX_SEGMENTS, MAX_DEPTH = 8, 4


def _check_paths(n, finish, seg, fold_each, chain, scale, paths):
    if seg is not None or fold_each or chain is not None or scale is not None or \
            finish != "uniform":
        raise ValueError("threefry_draw: paths= takes the finish 'uniform' and no seg, "
                         "fold_each, chain or scale")
    if not 1 <= len(paths) <= MAX_SEGMENTS:
        raise ValueError(f"threefry_draw: paths holds {len(paths)} segments, not 1 to "
                         f"{MAX_SEGMENTS}")
    for path, length in paths:
        if len(path) > MAX_DEPTH or any(not 0 <= int(i) <= R.M32 for i in path) or length < 0:
            raise ValueError(f"threefry_draw: segment {(path, length)} needs a path of at most "
                             f"{MAX_DEPTH} uint32 indices and a length >= 0")
    if sum(int(length) for _, length in paths) != n:
        raise ValueError(f"threefry_draw: the paths' lengths do not add up to n={n}")


def _check(n, finish, seg, fold_each, chain, scale=None, paths=None):
    if paths is not None:
        _check_paths(n, finish, seg, fold_each, chain, scale, paths)
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
                        chain=None, minval=0, maxval=1, scale=None, paths=None):
    """-> [*keys.shape[:-1], n] ([..., R, C, n] with a chain), on the
    keys' device."""
    _check(n, finish, seg, fold_each, chain, scale, paths)
    k = keys if t is None else R.fold_in(keys, t)
    if paths is not None:
        parts = []
        for path, length in paths:
            kk = k
            for i in path:
                kk = R.split(kk, int(i) + 1)[..., int(i), :]
            parts.append(R.uniform(kk, (int(length),), minval, maxval))
        return torch.cat(parts, dim=-1)
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
        lib.threefry_paths_launch.argtypes = [
            c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_uint, PathTable, c.c_float, c.c_float,
            c.c_void_p, c.c_void_p]
        lib.threefry_paths_launch.restype = ctypes.c_int
    return lib


class PathTable(ctypes.Structure):
    """csrc/threefry.cu's PathTable, passed to the kernel by value."""

    _fields_ = [("start", ctypes.c_int * (MAX_SEGMENTS + 1)),
                ("depth", ctypes.c_int * MAX_SEGMENTS),
                ("idx", (ctypes.c_uint * MAX_DEPTH) * MAX_SEGMENTS)]


def path_table(paths) -> PathTable:
    table = PathTable()
    start = 0
    for s, (path, length) in enumerate(paths):
        table.start[s] = start
        table.depth[s] = len(path)
        for d, i in enumerate(path):
            table.idx[s][d] = int(i)
        start += int(length)
    for s in range(len(paths), MAX_SEGMENTS + 1):
        table.start[s] = start
    return table


_OUT_DTYPE = {"bits": torch.int64, "uniform": torch.float32, "floor": torch.float32,
              "randint": torch.int32, "randint_f32": torch.float32}
_FINISH_CODE = {"bits": 0, "uniform": 1, "floor": 2, "randint": 3, "randint_f32": 4}


def threefry_draw_cuda(keys, t, n, *, finish="uniform", seg=None, fold_each=False,
                       chain=None, minval=0, maxval=1, scale=None, paths=None):
    """Launches csrc/threefry.cu on PyTorch's current stream. `t` and
    the bounds are host ints and floats; the keys and `scale` live on
    the device."""
    global launches, path_launches
    _check(n, finish, seg, fold_each, chain, scale, paths)
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
    if paths is not None:
        out = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
        lib = _lib()
        status = lib.threefry_paths_launch(
            keys.data_ptr(), F, n, int(t is not None), 0 if t is None else int(t) & R.M32,
            path_table(paths), float(minval), float(maxval), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(lib, status, "threefry_draw")
        launches += 1
        path_launches += 1
        return out
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
