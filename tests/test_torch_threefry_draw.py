"""The draw's Hopper design on the CPU (`kernels/threefry.py`): the slot
axis, one key walk a block, the `normal` finish, and the sources that
draw a block of slots a launch.

The plain draw's slot axis is held to per-slot draws and to `jax.random`
over ranges of slots up to 2**32 - 1; every walk (a path table, `seg`,
fold_each, chain) takes every finish, each against JAX's own
composition; the `normal` finish is `jax.random.normal` bitwise; `seg` is
the two-segment table. The kernel's geometry (`grid`, `block_span`) and
block keys (`block_keys`) are held to what they must cover and to JAX's
keys, and `threefry_draw_blocks`, the kernel's algorithm block by block,
to the plain draw. Block-drawing sources give every loop (simulate, the
V sweep, the fleet, the WAN, fault and deadline loops, `serve_loop`)
trajectories bitwise equal to per-slot draws.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.deadlines as PD  # noqa: E402
import repro_torch.faults as PF  # noqa: E402
import repro_torch.network as PN  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.configs import fleet_scenarios as tfs  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import threefry as tf  # noqa: E402
from repro_torch.serve import serve_loop  # noqa: E402

N_WALK = 7
WALKS = {
    "plain": {},
    "seg": {"seg": 3},
    "paths": {"paths": (((2, 0, 7), 4), ((1,), 1), ((0, 4), 0), ((), 2))},
    "fold_each": {"fold_each": True},
    "chain": {"chain": (3, 2)},
}
BOUNDS = {"uniform": dict(minval=-3.5, maxval=7.25), "randint": dict(minval=0, maxval=401),
          "randint_f32": dict(minval=-7, maxval=700)}


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def _kw(finish, n=N_WALK):
    kw = dict(finish=finish, **BOUNDS.get(finish, {}))
    if finish == "floor":
        kw["scale"] = torch.arange(1, n + 1, dtype=torch.float32) * 100.5
    return kw


def _jax_finish(key, m, finish, scale=None):
    """JAX's own call for a finish, m values from one key."""
    b = BOUNDS.get(finish, {})
    if finish == "bits":
        return np.asarray(jax.random.bits(key, (m,)))
    if finish == "uniform":
        return np.asarray(jax.random.uniform(key, (m,), minval=b["minval"], maxval=b["maxval"]))
    if finish == "normal":
        return np.asarray(jax.random.normal(key, (m,)))
    if finish == "floor":
        return np.asarray(jnp.floor(jax.random.uniform(key, (m,)) * jnp.asarray(scale)))
    v = np.asarray(jax.random.randint(key, (m,), b["minval"], b["maxval"]))
    return v.astype(np.float32) if finish == "randint_f32" else v


def _jax_walk(k, walk, finish, n, scale):
    """JAX's composition of a walk from the row key k."""
    if walk == "plain":
        return _jax_finish(k, n, finish, scale)
    if walk == "seg":
        halves = jax.random.split(k)
        s = WALKS["seg"]["seg"]
        return np.concatenate([_jax_finish(halves[0], s, finish, None if scale is None else
                                           scale[:s]),
                               _jax_finish(halves[1], n - s, finish, None if scale is None else
                                           scale[s:])])
    if walk == "paths":
        parts, start = [], 0
        for path, length in WALKS["paths"]["paths"]:
            kk = k
            for i in path:
                kk = jax.random.split(kk, i + 1)[i]  # child i of a split of any width
            parts.append(_jax_finish(kk, length, finish, None if scale is None else
                                     scale[start:start + length]))
            start += length
        return np.concatenate(parts)
    if walk == "fold_each":
        return np.concatenate([_jax_finish(jax.random.fold_in(k, j), 1, finish,
                                           None if scale is None else scale[j:j + 1])
                               for j in range(n)])
    rounds, children = WALKS["chain"]["chain"]
    rng, out = k, []
    for _ in range(rounds):
        rng, *subs = jax.random.split(rng, children + 1)
        out.append(np.stack([_jax_finish(sub, n, finish, scale) for sub in subs]))
    return np.stack(out)


# ------------------------------------------------------- the slot axis


@pytest.mark.parametrize("finish", tf.FINISHES)
@pytest.mark.parametrize("t0", [0, 190, 2**32 - 3])
def test_slot_axis_rows_are_single_slot_draws(finish, t0):
    """Row i of a draw over `count` slots is the draw at slot t0 + i
    (mod 2**32: the range from 2**32 - 3 wraps), for lanes of keys."""
    keys = R.split(R.PRNGKey(11, device="cpu"), 3)
    n, count = 9, 5
    block = ops.threefry_draw(keys, t0, n, count=count, **_kw(finish, n))
    assert block.shape == (count, 3, n)
    for i in range(count):
        _same(block[i], ops.threefry_draw(keys, (t0 + i) & R.M32, n, **_kw(finish, n)).numpy())


@pytest.mark.parametrize("t0", [0, 1999, 2**31 - 3, 2**32 - 6])
def test_slot_axis_is_jax_over_slots(t0):
    """randint, uniform and normal of fold_in(k, t) for t in a range of
    slots (up to 2**32 - 1) are JAX's under vmap over t, bitwise."""
    tk, jk = R.PRNGKey(2022, device="cpu"), jax.random.PRNGKey(2022)
    count, n = 6, 33
    ts = jnp.arange(count, dtype=jnp.uint32) + jnp.uint32(t0)

    def over_slots(fn):
        return np.asarray(jax.vmap(lambda t: fn(jax.random.fold_in(jk, t)))(ts))

    _same(ops.threefry_draw(tk, t0, n, count=count, finish="randint", minval=0, maxval=401),
          over_slots(lambda k: jax.random.randint(k, (n,), 0, 401)))
    _same(ops.threefry_draw(tk, t0, n, count=count, finish="uniform", minval=5.0, maxval=700.0),
          over_slots(lambda k: jax.random.uniform(k, (n,), minval=5.0, maxval=700.0)))
    _same(ops.threefry_draw(tk, t0, n, count=count, finish="normal"),
          over_slots(lambda k: jax.random.normal(k, (n,))))


def test_slot_axis_refuses_a_count_without_a_slot():
    keys = R.PRNGKey(0, device="cpu")
    for bad in (dict(t=None, count=3), dict(t=4, count=0)):
        with pytest.raises(ValueError):
            ops.threefry_draw(keys, bad["t"], 5, count=bad["count"])


# ----------------------------------------------- walks and finishes


@pytest.mark.parametrize("finish", tf.FINISHES)
@pytest.mark.parametrize("walk", list(WALKS))
def test_every_walk_takes_every_finish(walk, finish):
    """Every walk with every finish is JAX's composition of fold_in,
    split and the finish's own `jax.random` call, bitwise, and the
    kernel's algorithm on the CPU (`threefry_draw_blocks`) is the plain
    draw's."""
    tk, jk = R.PRNGKey(-1, device="cpu"), jax.random.PRNGKey(-1)
    kw = dict(_kw(finish), **WALKS[walk])
    got = tf.threefry_draw_plain(tk, 5, N_WALK, **kw)
    scale = None if "scale" not in kw else kw["scale"].numpy()
    _same(got, _jax_walk(jax.random.fold_in(jk, 5), walk, finish, N_WALK, scale))
    _same(tf.threefry_draw_blocks(tk, 5, N_WALK, **kw), got.numpy())


def test_normal_finish_is_jax_normal():
    """The `normal` finish (XLA's erfinv over its log1p) against
    jax.random.normal on 3 slots of 20,000 values and lanes of keys."""
    tk, jk = R.PRNGKey(7, device="cpu"), jax.random.PRNGKey(7)
    got = ops.threefry_draw(tk, 100, 20000, finish="normal", count=3)
    want = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(jk, t), (20000,)))
                     for t in (100, 101, 102)])
    _same(got, want)
    tks, jks = R.split(tk, 4), jax.random.split(jk, 4)
    _same(ops.threefry_draw(tks, 9, 50, finish="normal"),
          jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 9), (50,)))(jks))
    with pytest.raises(ValueError):
        ops.threefry_draw(tk, 9, 50, finish="normal", minval=-1.0)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_constants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # defines constants and functions; main() does not run
    return mod


def test_chip_smoke_normal_answers_are_jaxs():
    """NORMAL_KNOWN, which phase 3e holds the kernel's normal finish to,
    is jax 0.9.0's own output and the plain draw's."""
    for (seed, t), want in _chip_smoke().NORMAL_KNOWN.items():
        k = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        got = np.asarray(jax.random.normal(k, (len(want),))).view(np.uint32)
        assert tuple(int(x) for x in got) == want
        port = tf.threefry_draw_plain(R.PRNGKey(seed, device="cpu"), t, len(want),
                                      finish="normal")
        assert tuple(int(x) for x in port.numpy().view(np.uint32)) == want


@pytest.mark.parametrize("finish", ["randint_f32", "uniform", "floor"])
def test_seg_is_a_two_segment_table(finish):
    """A `seg` draw is the path table ((0,), seg), ((1,), n - seg), and
    both are the old composition: the two halves of split(k), each
    finished on its own."""
    keys = R.split(R.PRNGKey(4, device="cpu"), 5)
    n, seg = 12, 1
    kw = _kw(finish, n)
    got = ops.threefry_draw(keys, 17, n, seg=seg, **kw)
    table = ops.threefry_draw(keys, 17, n, paths=(((0,), seg), ((1,), n - seg)), **kw)
    halves = R.split(R.fold_in(keys, 17), 2)
    scale = kw.pop("scale", None)
    old = torch.cat([tf._finish(halves[..., 0, :], seg, finish, kw.get("minval", 0),
                                kw.get("maxval", 1), None if scale is None else scale[:seg]),
                     tf._finish(halves[..., 1, :], n - seg, finish, kw.get("minval", 0),
                                kw.get("maxval", 1), None if scale is None else scale[seg:])],
                    dim=-1)
    _same(got, table.numpy())
    _same(got, old.numpy())


# ------------------------------------------------- the kernel's twins


GRIDS = [(1, 4096, 64, None), (16, 4096, 2, None), (512, 5, 3, None), (3, 2100, 4, None),
         (1, 6, 256, None), (2, 257, 9, None), (5, 1, 7, None), (1, 7, 2, (64, 1)),
         (3, 5, 2, (24, 2)), (2, 1023, 3, None), (1, 511, 5, None)]


@pytest.mark.parametrize("F,n,count,chain", GRIDS)
def test_grid_covers_every_value_once(F, n, count, chain):
    """The blocks of `grid` write every flat position of the output once:
    16-byte-aligned starts, at most BLOCK_VALUES positions and MAX_ROWS
    rows a block, whole short rows, a long row over `chunks` blocks."""
    rows, per_row, rpb, chunks, blocks = tf.grid(F, n, count, chain)
    assert rows == F * count and per_row == n * (1 if chain is None else chain[0] * chain[1])
    assert 1 <= rpb <= tf.MAX_ROWS and (rpb == 1 or chunks == 1)
    seen = np.zeros(rows * per_row, np.int64)
    for b in range(blocks):
        r_lo, r_hi, a, g_lo, g_hi = tf.block_span(b, rows, per_row, rpb, chunks)
        assert a % tf.VEC == 0 and r_hi - r_lo <= rpb
        if g_lo < g_hi:
            assert a <= g_lo and g_hi <= a + tf.BLOCK_VALUES
            seen[g_lo:g_hi] += 1
    assert (seen == 1).all()


def test_path_table_layout():
    """The table the kernel reads: each segment's start, depth and child
    indices, the unused ones empty at n."""
    paths = tf.segments(19, paths=(((2, 0, 7), 9), ((1,), 1), ((0, 4), 0), ((), 6),
                                   ((5, 5, 5, 5), 3)))
    table = tf.path_table(paths)
    assert list(table.start) == [0, 9, 10, 10, 16, 19, 19, 19, 19]
    assert list(table.depth) == [3, 1, 2, 0, 4, 0, 0, 0]
    assert [list(table.idx[s])[:d] for s, d in zip(range(5), table.depth)] == [
        [2, 0, 7], [1], [0, 4], [], [5, 5, 5, 5]]
    assert tf.segments(8, seg=3) == (((0,), 3), ((1,), 5)) and tf.segments(8) == (((), 8),)


@pytest.mark.parametrize("two", [False, True])
def test_block_keys_are_jaxs(two):
    """A block's shared keys are JAX's: the table walk's touched segments
    at the end of their paths (split once more for randint), the other
    walks' folded row keys; a segment the block does not touch gets no
    key. Rows are (slot, lane): row r is slot t0 + r // F of key r % F."""
    F, t0 = 3, 2**32 - 2
    tks, jks = R.split(R.PRNGKey(5, device="cpu"), F), jax.random.split(jax.random.PRNGKey(5), F)
    paths = (((3, 1), 2), ((), 0), ((7,), 3))
    table = tf.segments(5, paths=paths)
    rows, per_row, rpb, chunks, blocks = tf.grid(F, 5, 4)
    span = tf.block_span(1, rows, per_row, rpb, chunks)
    keys = tf.block_keys(tks, t0, F, span, per_row, tf.WALK_TABLE, table, two)
    r_lo = span[0]
    assert {(rl, s) for rl, s, _ in keys} == {(rl, s) for rl in range(span[1] - r_lo)
                                               for s in (0, 2)}
    for (rl, s, h), k in keys.items():
        row = r_lo + rl
        jk = jax.random.fold_in(jks[row % F], (t0 + row // F) % 2**32)
        for i in paths[s][0]:
            jk = jax.random.fold_in(jk, i)
        if two:
            jk = jax.random.split(jk)[h]
        np.testing.assert_array_equal(R.key_data(k), np.asarray(jk))
    folded = tf.block_keys(tks, t0, F, span, per_row, tf.WALK_FOLD_EACH)
    for (rl, _, _), k in folded.items():
        row = r_lo + rl
        np.testing.assert_array_equal(
            R.key_data(k), np.asarray(jax.random.fold_in(jks[row % F], (t0 + row // F) % 2**32)))
    # a long row in chunks: the second chunk of a row of 3 segments touches
    # only the segments that reach into it
    table = tf.segments(2100, paths=(((0,), 1000), ((1,), 100), ((2,), 1000)))
    rows, per_row, rpb, chunks, _ = tf.grid(1, 2100, 1)
    span = tf.block_span(1, rows, per_row, rpb, chunks)
    assert span[3:] == (1024, 2048)
    assert {s for _, s, _ in tf.block_keys(tks[:1], None, 1, span, per_row, tf.WALK_TABLE,
                                           table)} == {1, 2}


BLOCK_CASES = [
    dict(F=1, n=4096, count=3, finish="randint_f32", minval=0, maxval=401),
    dict(F=3, n=5, count=40, finish="floor", lane_scale=True),
    dict(F=2, n=2100, count=2, finish="uniform", minval=-3.5, maxval=7.25,
         paths=(((0, 0), 1), ((0, 1), 700), ((0, 2), 1), ((0, 3), 397), ((0, 4), 1000),
                ((1,), 1))),
    dict(F=1, n=6, count=70, finish="normal", fold_each=True),
    dict(F=2, n=257, count=5, finish="randint", minval=0, maxval=701, seg=1),
    dict(F=3, n=9, count=None, finish="bits", chain=(24, 2)),
    dict(F=1, n=1023, count=3, finish="normal"),
]


@pytest.mark.parametrize("case", range(len(BLOCK_CASES)))
def test_blocks_twin_is_the_plain_draw(case):
    """The kernel's algorithm, block by block (short rows packed, long
    rows in chunks, rows off a 16-byte boundary, the fault slot's six
    segments, fold_each and chain from the shared folded key), bitwise
    the plain draw."""
    kw = dict(BLOCK_CASES[case])
    F, n, count = kw.pop("F"), kw.pop("n"), kw.pop("count")
    keys = R.split(R.PRNGKey(case, device="cpu"), F)
    if kw.pop("lane_scale", False):
        kw["scale"] = torch.arange(F * n, dtype=torch.float32).reshape(F, n) * 37.25 + 1.0
    t0 = None if count is None else 2**32 - 7
    got = tf.threefry_draw_blocks(keys, t0, n, count=count, **kw)
    _same(got, tf.threefry_draw_plain(keys, t0, n, count=count, **kw).numpy())


# ------------------------------------------- block sources in the loops


class _PerSlot:
    """A source seen without its `block` method: drawn once a slot."""

    def __init__(self, source):
        self.source = source

    def to(self, device):
        getattr(self.source, "to", lambda d: None)(device)
        return self

    def __call__(self, t, key, device):
        return self.source(t, key, device)


def _draw_calls(monkeypatch):
    """The non-paths ops.threefry_draw calls of a run, as (count) each."""
    calls, real = [], ops.threefry_draw

    def counting(*a, **kw):
        if kw.get("paths") is None:
            calls.append(kw.get("count"))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "threefry_draw", counting)
    return calls


def _assert_same_result(a, b):
    for name in type(a)._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None
        elif torch.is_tensor(x):
            assert torch.equal(x, y), name
        else:
            _assert_same_result(x, y)


M, N, T = 6, 4, 10


def _spec():
    return tfs._base(M, N)


LOOPS = ("simulate", "vsweep", "graph", "faults", "deadlines", "fleet", "fleet_faults_deadlines",
         "wan_fleet")


def _run(loop, carbon, arrivals):
    """One run of `loop` on the CPU with the given sources (the fleets
    build their own FleetArrivals)."""
    pol = P.CarbonIntensityPolicy(V=0.05)
    if loop == "simulate":
        return P.simulate(pol, _spec(), carbon, arrivals, T, 3, device="cpu")
    if loop == "vsweep":
        return P.simulate_vsweep(lambda V: P.CarbonIntensityPolicy(V=V), [0.01, 0.05], _spec(),
                                 carbon, arrivals, T, 3, device="cpu")
    if loop == "graph":
        g = PN.star_graph(M, N, np.random.default_rng(1))
        return P.simulate(PN.NetworkAwareDPPPolicy(), _spec(), carbon, arrivals, T, 3,
                          device="cpu", graph=g)
    if loop == "faults":
        return P.simulate(pol, _spec(), carbon, arrivals, T, 3, device="cpu",
                          faults=PF.make_faults(N, device="cpu", task_p_fail=0.3))
    if loop == "deadlines":
        return P.simulate(PD.SlackThresholdPolicy(V=0.05), _spec(), carbon, arrivals, T, 3,
                          device="cpu", deadlines=PD.make_deadlines(M, device="cpu",
                                                                    deadline=3.0, shed_on=1.0))
    fleet = tfs.build_fleet(["diurnal-slack", "overload"], per_kind=2, M=M, N=N, Tc=24, seed=0,
                            device="cpu")
    if loop == "wan_fleet":
        fleet = tfs.build_network_fleet(["congested-uplink"], per_kind=3, M=M, N=N, Tc=24, seed=0,
                                        device="cpu")
        return P.simulate_fleet(PN.NetworkAwareDPPPolicy(), fleet, T, 3, device="cpu")
    if loop == "fleet_faults_deadlines":
        fleet = tfs.with_deadlines(tfs.with_faults(fleet, "regional-blackout"), "shed-overload")
        return P.simulate_fleet(PD.SlackThresholdPolicy(V=0.05), fleet, T, 3, device="cpu")
    return P.simulate_fleet(pol, fleet, T, 3, device="cpu")


@pytest.mark.parametrize("loop", LOOPS)
def test_block_sources_equal_per_slot_draws(loop, monkeypatch):
    """Each loop draws its block sources (RandomCarbonSource,
    UniformArrivals, the fleet's FleetArrivals) once a run, and its
    trajectory is bitwise the one drawn a slot at a time."""
    carbon, arrivals = P.RandomCarbonSource(N=N), P.UniformArrivals(M=M, amax=40)
    calls = _draw_calls(monkeypatch)
    blocked = _run(loop, carbon, arrivals)
    fleet = loop.endswith("fleet") or loop.startswith("fleet")
    assert calls == [T] * (1 if fleet else 2)  # arrivals (and carbon) one block a run
    calls.clear()
    monkeypatch.setattr(S, "_blocked", lambda source, horizon: source)
    per_slot = _run(loop, _PerSlot(carbon), _PerSlot(arrivals))
    assert calls == [None] * ((1 if fleet else 2) * T)
    _assert_same_result(blocked, per_slot)


def test_block_length_is_cut_by_bytes(monkeypatch):
    """Under a smaller byte cap a run draws several blocks, the last cut
    at the horizon, and stays bitwise."""
    carbon, arrivals = P.RandomCarbonSource(N=N), P.UniformArrivals(M=M, amax=40)
    want = _run("simulate", _PerSlot(carbon), _PerSlot(arrivals))
    monkeypatch.setattr(S, "BLOCK_BYTES", 4 * 4 * M)  # 4 slots of arrivals
    calls = _draw_calls(monkeypatch)
    got = _run("simulate", carbon, arrivals)
    # arrivals: 4 + 4 + 2 slots; carbon (N + 1 = 5 values a slot): 4 slots of 5 fit in 96 bytes
    assert sorted(calls) == sorted([4, 4, 2, 4, 4, 2])
    _assert_same_result(got, want)


def test_serve_is_simulate_with_block_sources():
    """serve_loop draws a slot at a time and simulate a block: the same
    trajectory, bitwise."""
    carbon, arrivals = P.RandomCarbonSource(N=N), P.UniformArrivals(M=M, amax=40)
    pol = P.CarbonIntensityPolicy(V=0.05)
    rep = serve_loop(pol, _spec(), carbon, arrivals, T, 3, device="cpu")
    res = P.simulate(pol, _spec(), carbon, arrivals, T, 3, device="cpu")
    np.testing.assert_array_equal(rep.emissions, res.emissions.numpy())
    assert torch.equal(rep.state.Qe, res.Qe[-1]) and torch.equal(rep.state.Qc, res.Qc[-1])


def test_uk_trace_noise_is_one_normal_draw_a_block():
    """The UK trace's noise is one `normal` fold_each draw over its block
    of slots, each row the per-slot draw of JAX's keys."""
    src = P.UKRegionalTraceSource(N=5)
    base = R.PRNGKey(src.seed, device="cpu")
    block = ops.threefry_draw(base, 0, 6, finish="normal", fold_each=True, count=8)
    for t in range(8):
        keys = R.fold_in(R.fold_in(base, t)[None, :], torch.arange(6))
        _same(block[t], R.normal(keys, ()).numpy())
    assert src.table(8, device="cpu").shape == (8, 6)


def test_erfinv_twin_takes_a_correctly_rounded_sqrt():
    """Above w = 5, XLA's erfinv takes sqrt(w), correctly rounded; torch's
    float32 sqrt on the CPU is not (about 0.7% of inputs an ulp off), so
    the twin rounds the float64 root once. Then the twin is jit(erf_inv)
    bitwise on inputs where the sqrt branch runs, as the kernel's
    __fsqrt_rn is."""
    from repro_torch.kernels.numerics import erfinv_xla

    u = np.random.default_rng(3).uniform(0.9967, 1.0, 200000).astype(np.float32)
    u = np.concatenate([u, -u])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    _same(erfinv_xla(torch.from_numpy(u)), want)
