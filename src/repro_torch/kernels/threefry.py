"""JAX's threefry draws: plain PyTorch version, CUDA wrapper, and Python
twins of the kernel's geometry and block keys.

A draw takes base keys [*lead, 2] (int64 holding uint32 pairs, see
`repro_torch.random`) and an optional slot `t`, and writes [*lead, n]:
each row from its key k = fold_in(keys, t) (keys itself when t is None),
along one walk and one finish.

  count:     a range of slots: t is the first, and the draw writes
             [count, *lead, n], row i bitwise the draw at slot t + i
             (mod 2**32), each slot's fold on the device
  walks      (child i of a key is split(k, *)[i] = fold_in(k, i)):
    paths:     ((path, length), ...): the n = sum(lengths) values are
               segments, each from the key reached from k by `path`, a
               tuple of child indices, counters 0.. in each segment (up
               to 8 segments of paths up to 4 deep): the fault stream's
               six uniforms a slot in one draw. `seg` is two segments,
               paths (0,) and (1,): values 0..seg-1 from the first half
               of split(k), the rest from the second; a plain draw is
               one segment with the empty path
    fold_each: value j from fold_in(k, j), counter 0
    chain=(R, C): [..., R, C, n], round r's draw c from child c + 1 of
               k_r, k_0 = k, k_{r+1} = child 0 of k_r: the key walk of
               `random.poisson`'s loops, every round in one draw
  finish:    "bits" (int64), "uniform" (float32 on [minval, maxval)),
             "floor" (floor(uniform * scale), float32, scale [n] or
             [*lead, n]; the fleet's arrivals), "randint" (int32),
             "randint_f32" (its float32) or "normal" (float32, JAX's
             normal: XLA's erfinv over its log1p); every walk takes
             every finish

The plain version is that composition of `repro_torch.random`'s
functions. The kernel (`csrc/threefry.cu`, whose note gives its bound
and design) is one launch a draw with t an argument: no host work and no
host-to-device copy. Each of its blocks derives the keys of its values
once (`grid`, `block_span` and `block_keys` are its twins here, and
`threefry_draw_blocks` runs its algorithm on the CPU for the tests).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import random as R
from repro_torch.kernels import build

# Launches of the CUDA kernel in this process (read by chip_smoke.py);
# `path_launches` counts those of them that drew `paths=`.
launches = 0
path_launches = 0

FINISHES = ("bits", "uniform", "floor", "randint", "randint_f32", "normal")
MAX_SEGMENTS, MAX_DEPTH = 8, 4
# the kernel's geometry (csrc/threefry.cu): threads a block, consecutive
# values a thread, positions a block, short rows a block
THREADS, VEC = 256, 4
BLOCK_VALUES = THREADS * VEC
MAX_ROWS = 32
WALK_TABLE, WALK_FOLD_EACH, WALK_CHAIN = 0, 1, 2
_TWO_KEYS = ("randint", "randint_f32")


def segments(n, seg=None, paths=None) -> tuple:
    """The ((path, length), ...) of a table walk: `paths` as given, a
    `seg` split as paths (0,) and (1,), else the empty path for all n."""
    if paths is not None:
        return tuple((tuple(int(i) for i in path), int(length)) for path, length in paths)
    if seg is not None:
        return (((0,), int(seg)), ((1,), n - int(seg)))
    return (((), n),)


def _check(n, finish, seg, fold_each, chain, scale, paths, t, count, minval, maxval):
    if finish not in FINISHES:
        raise ValueError(f"threefry_draw: finish {finish!r} is not one of {FINISHES}")
    if n < 1:
        raise ValueError(f"threefry_draw: n={n} must be >= 1")
    if sum((seg is not None, bool(fold_each), chain is not None, paths is not None)) > 1:
        raise ValueError("threefry_draw: seg, fold_each, chain and paths are walks: take one")
    if seg is not None and not 0 <= seg <= n:
        raise ValueError(f"threefry_draw: seg={seg} must lie in [0, n={n}]")
    if chain is not None and (chain[0] < 1 or chain[1] < 1):
        raise ValueError(f"threefry_draw: chain={chain} needs R, C >= 1")
    if paths is not None:
        if not 1 <= len(paths) <= MAX_SEGMENTS:
            raise ValueError(f"threefry_draw: paths holds {len(paths)} segments, not 1 to "
                             f"{MAX_SEGMENTS}")
        for path, length in paths:
            if len(path) > MAX_DEPTH or any(not 0 <= int(i) <= R.M32 for i in path) or \
                    length < 0:
                raise ValueError(f"threefry_draw: segment {(path, length)} needs a path of at "
                                 f"most {MAX_DEPTH} uint32 indices and a length >= 0")
        if sum(int(length) for _, length in paths) != n:
            raise ValueError(f"threefry_draw: the paths' lengths do not add up to n={n}")
    if count is not None and (t is None or int(count) < 1):
        raise ValueError(f"threefry_draw: count={count} needs a first slot t and count >= 1")
    if finish == "floor" and scale is None:
        raise ValueError("threefry_draw: finish 'floor' needs a scale")
    if finish == "normal" and (minval, maxval) != (0, 1):
        raise ValueError("threefry_draw: finish 'normal' takes no bounds")
    if n * (1 if chain is None else chain[0] * chain[1]) >= 2**31:
        raise ValueError("threefry_draw: a row holds 2**31 values or more")


def row_keys(keys, t, count=None) -> torch.Tensor:
    """The rows' keys: fold_in(keys, t) [*lead, 2], over `count` slots
    from t [count, *lead, 2], or the keys when t is None."""
    if t is None:
        return keys
    if count is None:
        return R.fold_in(keys, t)
    slots = (int(t) + torch.arange(int(count), device=keys.device)) & R.M32
    return R.fold_in(keys, slots.reshape((-1,) + (1,) * (keys.dim() - 1)))


def child(key, i) -> torch.Tensor:
    """Child i of a key, split(key, *)[i]: threefry(key, (0, i))."""
    return R.fold_in(key, int(i))


def _finish(key, n, finish, minval, maxval, scale):
    if finish == "bits":
        return R.random_bits(key, (n,))
    if finish == "uniform":
        return R.uniform(key, (n,), minval, maxval)
    if finish == "normal":
        return R.normal(key, (n,))
    if finish == "floor":
        return torch.floor(R.uniform(key, (n,)) * scale)
    out = R.randint(key, (n,), minval, maxval)
    return out.float() if finish == "randint_f32" else out


def threefry_draw_plain(keys, t, n, *, finish="uniform", seg=None, fold_each=False,
                        chain=None, minval=0, maxval=1, scale=None, paths=None, count=None):
    """-> [*keys.shape[:-1], n] ([..., R, C, n] with a chain; a leading
    [count] with `count`), on the keys' device."""
    _check(n, finish, seg, fold_each, chain, scale, paths, t, count, minval, maxval)
    k = row_keys(keys, t, count)
    if chain is not None:
        rounds, children = chain
        out = []
        for _ in range(rounds):
            out.append(torch.stack([_finish(child(k, c), n, finish, minval, maxval, scale)
                                    for c in range(1, children + 1)], dim=-2))
            k = child(k, 0)
        return torch.stack(out, dim=-3)
    if fold_each:
        kj = R.fold_in(k[..., None, :], torch.arange(n, device=k.device))
        return _finish(kj, 1, finish, minval, maxval,
                       None if scale is None else scale[..., None])[..., 0]
    parts, start = [], 0
    for path, length in segments(n, seg, paths):
        kk = k
        for i in path:
            kk = child(kk, i)
        part = None if scale is None else scale[..., start:start + length]
        parts.append(_finish(kk, length, finish, minval, maxval, part))
        start += length
    return torch.cat(parts, dim=-1)


# ------------------------------------------------ the kernel's twins


def grid(F, n, count=1, chain=None) -> tuple:
    """The launch's geometry as `threefry_draw_launch` computes it:
    (rows, values a row, rows a block, blocks a row group, blocks). A
    row is one (slot, key); up to MAX_ROWS short rows share a block
    (each fits whole beside the 3 positions of the 16-byte alignment),
    a long row spreads over `chunks` blocks."""
    per_row = n * (1 if chain is None else chain[0] * chain[1])
    rows = count * F
    rows_per_block = min(max((BLOCK_VALUES - (VEC - 1)) // per_row, 1), MAX_ROWS)
    pad = VEC - 1 if per_row % VEC else 0
    chunks = -(-(per_row + pad) // BLOCK_VALUES)
    return rows, per_row, rows_per_block, chunks, -(-rows // rows_per_block) * chunks


def block_span(b, rows, per_row, rows_per_block, chunks) -> tuple:
    """Block b's rows [r_lo, r_hi), its aligned first position a, and
    the flat positions [g_lo, g_hi) it writes (empty: g_lo >= g_hi)."""
    group, chunk = divmod(b, chunks)
    r_lo = group * rows_per_block
    r_hi = min(rows, r_lo + rows_per_block)
    a = (r_lo * per_row) // VEC * VEC + chunk * BLOCK_VALUES
    return r_lo, r_hi, a, max(a, r_lo * per_row), min(a + BLOCK_VALUES, r_hi * per_row)


def block_keys(keys, t, F, span, per_row, walk, table=None, two=False) -> dict:
    """The keys block `span` (from `block_span`) holds in shared memory
    before its values are drawn: {(row in block, segment, child): key
    [2]} for the table walk (a touched segment's key, or with `two`
    randint's split of it, children 0 and 1), {(row in block, 0, 0):
    the row's folded key} for the others. `keys` [F, 2]; row r is slot
    t + r // F of key r % F; `table` the walk's segments."""
    r_lo, r_hi, _, g_lo, g_hi = span
    out = {}
    for rl in range(r_hi - r_lo):
        row = r_lo + rl
        k = keys[row % F]
        if t is not None:
            k = child(k, (int(t) + row // F) & R.M32)
        if walk != WALK_TABLE:
            out[(rl, 0, 0)] = k
            continue
        jl, jh = max(g_lo - row * per_row, 0), min(g_hi - row * per_row, per_row)
        start = 0
        for s, (path, length) in enumerate(table):
            if start < jh and start + length > jl:
                kk = k
                for i in path:
                    kk = child(kk, i)
                for h in ((0, 1) if two else (0,)):
                    out[(rl, s, h)] = child(kk, h) if two else kk
            start += length
    return out


def _bits_at(key, counters):
    y1, y2 = R.threefry2x32(key[0], key[1], torch.zeros_like(counters), counters)
    return y1 ^ y2


def threefry_draw_blocks(keys, t, n, *, finish="uniform", seg=None, fold_each=False,
                         chain=None, minval=0, maxval=1, scale=None, paths=None, count=None):
    """The kernel's algorithm on the CPU, block by block (the tests' twin
    of csrc/threefry.cu): the blocks of `grid`, each block's keys from
    `block_keys`, then one hash a value (two for randint) from them, the
    fold_each and chain values each walking from its row's folded key.
    Takes and returns what `threefry_draw_plain` does."""
    _check(n, finish, seg, fold_each, chain, scale, paths, t, count, minval, maxval)
    lead = tuple(keys.shape[:-1])
    F = math.prod(lead)
    flat_keys = keys.reshape(F, 2)
    walk = WALK_CHAIN if chain is not None else WALK_FOLD_EACH if fold_each else WALK_TABLE
    table = segments(n, seg, paths)
    two = finish in _TWO_KEYS
    rows, per_row, rpb, chunks, blocks = grid(F, n, 1 if count is None else count, chain)
    lanes_scale = None
    if scale is not None:
        lanes_scale = torch.broadcast_to(scale, lead + (n,)).reshape(F, n)
    out = torch.zeros(rows * per_row, dtype=_OUT_DTYPE[finish])
    for b in range(blocks):
        span = block_span(b, rows, per_row, rpb, chunks)
        r_lo, r_hi, _, g_lo, g_hi = span
        if g_lo >= g_hi:
            continue
        sk = block_keys(flat_keys, t, F, span, per_row, walk, table, two)
        for row in range(r_lo, r_hi):
            j = torch.arange(max(g_lo - row * per_row, 0), min(g_hi - row * per_row, per_row))
            if j.numel() == 0:
                continue
            rl, jj = row - r_lo, j % n
            k1 = torch.empty(j.shape + (2,), dtype=torch.int64)
            k2 = torch.zeros_like(k1)
            counter = j.clone()
            if walk == WALK_TABLE:
                start = 0
                for s, (_, length) in enumerate(table):
                    m = (j >= start) & (j < start + length)
                    if bool(m.any()):
                        k1[m] = sk[(rl, s, 0)]
                        if two:
                            k2[m] = sk[(rl, s, 1)]
                        counter[m] = j[m] - start
                    start += length
            else:
                base = sk[(rl, 0, 0)]
                if walk == WALK_FOLD_EACH:
                    k1 = R.fold_in(base[None, :], j)
                    counter = torch.zeros_like(j)
                else:
                    rc = j // n
                    # the plain version reads the rows' chains on the host
                    for q in torch.unique(rc).tolist():  # lint: allow=host-cast,torch-for
                        r, c = divmod(q, chain[1])
                        kk = base
                        for _ in range(r):
                            kk = child(kk, 0)
                        k1[rc == q] = child(kk, c + 1)
                    counter = jj
                if two:
                    k1, k2 = R.fold_in(k1, 0), R.fold_in(k1, 1)
            b1 = _bits_at(k1.unbind(-1), counter)
            vals = _finish_bits(finish, b1, _bits_at(k2.unbind(-1), counter) if two else None,
                                minval, maxval,
                                None if lanes_scale is None else lanes_scale[row % F, jj])
            out[row * per_row + j] = vals
    inner = (n,) if chain is None else (chain[0], chain[1], n)
    return out.reshape(((count,) if count is not None else ()) + lead + inner)


def _finish_bits(finish, b1, b2, minval, maxval, scale):
    """The finishes of csrc/threefry.cu's `finish_value` on a value's bits
    (b2: randint's second key's)."""
    if finish == "bits":
        return b1
    if finish in _TWO_KEYS:
        v = R.randint_of_bits(b1, b2, minval, maxval)
        return v.float() if finish == "randint_f32" else v
    if finish == "floor":
        return torch.floor(R.uniform_of_bits(b1) * scale)
    if finish == "normal":
        return R.normal_of_bits(b1)
    return R.uniform_of_bits(b1, minval, maxval)


# ------------------------------------------------------- the wrapper


def _lib():
    lib = build.load("threefry")
    if lib.threefry_draw_launch.argtypes is None:
        c = ctypes
        lib.threefry_draw_launch.argtypes = [
            c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_uint, c.c_int, c.c_int, c.c_int,
            c.c_int, PathTable, c.c_int, c.c_float, c.c_float, c.c_int, c.c_ulonglong,
            c.c_ulonglong, c.c_void_p, c.c_int, c.c_void_p, c.c_void_p]
        lib.threefry_draw_launch.restype = ctypes.c_int
    return lib


class PathTable(ctypes.Structure):
    """csrc/threefry.cu's PathTable, passed to the kernel by value."""

    _fields_ = [("start", ctypes.c_int * (MAX_SEGMENTS + 1)),
                ("depth", ctypes.c_int * MAX_SEGMENTS),
                ("idx", (ctypes.c_uint * MAX_DEPTH) * MAX_SEGMENTS)]


def path_table(paths) -> PathTable:
    """The kernel's table of `segments(...)`: each segment's start, depth
    and child indices; the unused segments start (and end) at n."""
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
              "randint": torch.int32, "randint_f32": torch.float32, "normal": torch.float32}
_FINISH_CODE = {"bits": 0, "uniform": 1, "floor": 2, "randint": 3, "randint_f32": 4, "normal": 5}


def threefry_draw_cuda(keys, t, n, *, finish="uniform", seg=None, fold_each=False,
                       chain=None, minval=0, maxval=1, scale=None, paths=None, count=None):
    """Launches csrc/threefry.cu on PyTorch's current stream. `t`, `count`
    and the bounds are host ints and floats; the keys and `scale` live
    on the device."""
    global launches, path_launches
    _check(n, finish, seg, fold_each, chain, scale, paths, t, count, minval, maxval)
    dev = keys.device
    if keys.dtype != torch.int64 or keys.shape[-1] != 2:
        raise ValueError(f"threefry_draw: keys must be int64 [..., 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    lead = tuple(keys.shape[:-1])
    F = math.prod(lead)
    if F < 1:
        raise ValueError("threefry_draw: no keys")
    keys = keys.contiguous()
    span = mult = 1
    mn = 0
    if finish in _TWO_KEYS:
        mn, span, mult = R.randint_span(minval, maxval)
    lo, hi = (R.NORMAL_LO, 1.0) if finish == "normal" else (float(minval), float(maxval))
    scale_per_lane = 0
    if finish == "floor":
        if scale.dtype != torch.float32 or scale.device != dev:
            raise ValueError(f"threefry_draw: finish 'floor' needs a float32 scale on {dev}")
        if tuple(scale.shape) == lead + (n,):
            scale_per_lane = 1
        elif tuple(scale.shape) != (n,):
            raise ValueError(f"threefry_draw: scale {tuple(scale.shape)} is neither "
                             f"{lead + (n,)} nor ({n},)")
        scale = scale.contiguous()
    walk = WALK_CHAIN if chain is not None else WALK_FOLD_EACH if fold_each else WALK_TABLE
    rounds, children = (1, 1) if chain is None else (int(chain[0]), int(chain[1]))
    slots = 1 if count is None else int(count)
    rows, *_, blocks = grid(F, n, slots, chain)
    if max(rows, blocks) >= 2**31:
        raise ValueError("threefry_draw: the draw needs 2**31 rows or blocks or more")
    inner = (n,) if chain is None else (rounds, children, n)
    out = torch.empty(((slots,) if count is not None else ()) + lead + inner,
                      dtype=_OUT_DTYPE[finish], device=dev)
    lib = _lib()
    status = lib.threefry_draw_launch(
        keys.data_ptr(), F, n, int(t is not None), 0 if t is None else int(t) & R.M32, slots,
        walk, rounds, children, path_table(segments(n, seg, paths)), _FINISH_CODE[finish],
        lo, hi, int(mn), int(span), int(mult),
        scale.data_ptr() if scale is not None else None, scale_per_lane, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, status, "threefry_draw")
    launches += 1
    if paths is not None:
        path_launches += 1
    return out
