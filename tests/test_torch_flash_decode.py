"""The port's flash-decode plain version against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
oracle is `repro.kernels.ops.flash_decode_ref` over `tests/test_kernels.py`'s
decode sweep, plus pos = 0, pos = S-1, a ragged S (the serving run's
4161) and G = 16 queries per kv head (GLM-4-9B's 32 on 2); two cases also
go against the Pallas kernel in interpret mode. PaliGemma's decode (hd
256, MQA at K 1, G 8) runs at pos 0, 63, 64, 127, 128 and 4160 of its
4161-slot cache, in f32 and bf16, against both. Tolerances are
test_kernels.py's: 2e-5 in f32, 2e-2 in bf16. The CUDA kernel is held
against this plain version on the card by chip_smoke.py (phase 3c); its
wrapper refuses a head dim that neither route takes before anything is
built.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(B, H, K, S, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, hd), (B, S, K, hd), (B, S, K, hd))]
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs], [jnp.asarray(a).astype(jdt) for a in arrs])


def _run(B, H, K, S, hd, pos, dtype, seed):
    (tq, tk, tv), (jq, jk, jv) = _inputs(B, H, K, S, hd, dtype, seed)
    got = ops.flash_decode(tq, tk, tv, torch.tensor(pos, dtype=torch.int32))
    assert got.dtype == tq.dtype and got.shape == (B, H, hd)
    want = jops.flash_decode_ref(jq, jk, jv, jnp.int32(pos))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,S,hd,pos", [
    (2, 8, 2, 512, 64, 511),     # GQA, full cache
    (1, 4, 4, 1024, 64, 100),    # MHA, partial cache
    (2, 8, 1, 256, 128, 0),      # MQA, single valid slot
    (1, 16, 2, 2048, 64, 1500),  # long cache, mid position
])
def test_plain_matches_reference_sweep(B, H, K, S, hd, pos, dtype):
    _run(B, H, K, S, hd, pos, dtype, seed=S + pos)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,S,hd,pos", [
    (2, 32, 2, 300, 128, 0),      # G = 16, first position only
    (2, 32, 2, 300, 128, 299),    # G = 16, pos = S-1
    (1, 32, 2, 4161, 128, 4160),  # the serving run's ragged cache, full
    (1, 32, 2, 4161, 128, 256),   # a split-chunk edge of the kernel (256 positions)
    (3, 4, 4, 37, 16, 17),        # MHA, tiny ragged S
])
def test_plain_matches_reference_edges(B, H, K, S, hd, pos, dtype):
    _run(B, H, K, S, hd, pos, dtype, seed=S * 3 + pos)


@pytest.mark.parametrize("B,H,K,S,hd,bs,pos,dtype", [
    (2, 8, 2, 512, 64, 256, 300, "float32"),
    (1, 16, 2, 256, 32, 128, 0, "bfloat16"),
])
def test_plain_matches_pallas_interpret(B, H, K, S, hd, bs, pos, dtype):
    (tq, tk, tv), (jq, jk, jv) = _inputs(B, H, K, S, hd, dtype, seed=11)
    got = ops.flash_decode(tq, tk, tv, torch.tensor(pos, dtype=torch.int32))
    want = jops.flash_decode(jq, jk, jv, jnp.int32(pos), block_s=bs, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos", [0, 63, 64, 127, 128, 4160])
def test_plain_matches_reference_hd256(pos, dtype):
    """PaliGemma's decode: G 8 on one kv head, hd 256, its serving cache
    of 4161 slots; pos on either side of the hd 256 kernel's 64-key tiles."""
    _run(1, 8, 1, 4161, 256, pos, dtype, seed=pos + 256)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_interpret_hd256(dtype):
    (tq, tk, tv), (jq, jk, jv) = _inputs(2, 8, 1, 512, 256, dtype, seed=13)
    got = ops.flash_decode(tq, tk, tv, torch.tensor(300, dtype=torch.int32))
    want = jops.flash_decode(jq, jk, jv, jnp.int32(300), block_s=256, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol(dtype))


@pytest.mark.parametrize("hd", [48, 512])
def test_cuda_wrapper_refuses_other_head_dims_before_building(hd, monkeypatch):
    from repro_torch.kernels import flash_decode as fd_module

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(fd_module.build, "load", no_build)
    for dtype in DTYPES:
        (tq, tk, tv), _ = _inputs(1, 8, 1, 32, hd, dtype, seed=hd)
        with pytest.raises(ValueError, match="hd"):
            fd_module.flash_decode_cuda(tq, tk, tv, torch.tensor([5], dtype=torch.int32))


def test_positions_past_pos_are_ignored():
    """Changing the cache beyond pos changes nothing; pos may be an int."""
    (tq, tk, tv), _ = _inputs(1, 8, 2, 64, 16, "float32", seed=5)
    before = ops.flash_decode(tq, tk, tv, 40)
    tk[:, 41:] = 1e4
    tv[:, 41:] = -1e4
    after = ops.flash_decode(tq, tk, tv, torch.tensor(40, dtype=torch.int32))
    assert torch.equal(before, after)


# --- the bf16 CUDA kernel's arithmetic -----------------------------------
# csrc/flash_decode.cu's bf16 route (`decode_tc`) splits the cache into
# `_split_len` positions per block and scores tiles of `_tile` keys in
# 16-key slices, each slice with its own online softmax (scores q.k in
# float32, the scale log2(e)/sqrt(hd) inside exp2): a warp a slice over
# 128-key tiles (8 warps), or at hd 256 (`decode_tc<256>`) 8 warps over 64-key
# tiles, the two warps of a slice computing the same scores and softmax
# and each multiplying P into one half of the output columns. P.V runs on
# bf16 tensor cores with P split into hi + lo; the slices are merged, then
# the splits (only the rows of real queries are carried). This float32
# emulation of that order is held to chip_smoke.py phase 3c's bf16
# tolerance against the plain version, at 3c's decode shapes with B cut
# to 1-2; rounding P once instead misses it.

BF16_ATOL, BF16_RTOL = 1e-4, 2.0 ** -7  # chip_smoke.py ATTN_TOL: one bf16 rounding step
SMS, WARP_KEYS, MIN_SPLIT, MAX_SPLITS = 132, 16, 256, 64  # as csrc/flash_decode.cu


def _tile(hd):
    """Keys a tile: 8 slices of 16 (a warp each), or 4 at hd 256 (two
    warps each, one a column half: `Tc<256>`)."""
    return 64 if hd > 128 else 128


def _split_len(units, S):
    splits = max(1, min(MAX_SPLITS, SMS // units))
    n = -(-S // splits)
    return max(-(-n // 16) * 16, MIN_SPLIT)


def _decode_emulation(q, k, v, pos, *, split=True):
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    c = (1.0 / np.sqrt(hd)) * np.log2(np.e)
    n = _split_len(B * K * -(-G // 16), S)
    tile = _tile(hd)
    last = min(pos, S - 1)
    qf = q.float().reshape(B, K, G, hd)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)  # [B,K,S,hd]
    parts = []
    for s0 in range(0, last + 1, n):
        s1 = min(s0 + n, last + 1)
        warps = []
        for w in range(tile // WARP_KEYS):  # the key slices
            m = torch.full((B, K, G), -np.inf)
            l = torch.zeros((B, K, G))
            o = torch.zeros((B, K, G, hd))
            for t0 in range(s0, s1, tile):
                a, e = t0 + w * WARP_KEYS, min(t0 + (w + 1) * WARP_KEYS, s1)
                if a >= e:
                    continue
                sc = qf @ kf[:, :, a:e].transpose(-1, -2)  # raw scores [B,K,G,keys]
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp2((m - m_new) * c)
                p = torch.exp2(sc * c - (m_new * c)[..., None])
                l = alpha * l + p.sum(-1)
                hi = p.bfloat16().float()
                pv = hi @ vf[:, :, a:e]
                if split:
                    pv = pv + (p - hi).bfloat16().float() @ vf[:, :, a:e]
                o = alpha[..., None] * o + pv
                m = m_new
            warps.append((m, l, o))
        M = torch.stack([w[0] for w in warps]).amax(0)
        f = [torch.where(w[0] == -np.inf, 0.0, torch.exp2((w[0] - M) * c)) for w in warps]
        parts.append((M, sum(fi * w[1] for fi, w in zip(f, warps)),
                      sum(fi[..., None] * w[2] for fi, w in zip(f, warps))))
    M = torch.stack([p[0] for p in parts]).amax(0)
    f = [torch.exp2((p[0] - M) * c) for p in parts]
    L = sum(fi * p[1] for fi, p in zip(f, parts))
    O = sum(fi[..., None] * p[2] for fi, p in zip(f, parts))
    return (O / L.clamp_min(1e-30)[..., None]).reshape(B, H, hd).to(torch.bfloat16)


def _misses(got, want):
    diff = (got.float() - want.float()).abs()
    return int((diff > BF16_ATOL + BF16_RTOL * want.float().abs()).sum())


DECODE_CASES = [  # chip_smoke 3c's bf16 decode cases with B cut: B, H, K, S, hd, pos
    (2, 32, 2, 4161, 128, 0), (2, 32, 2, 4161, 128, 511), (2, 32, 2, 4161, 128, 512),
    (2, 32, 2, 4161, 128, 4095), (2, 32, 2, 4161, 128, 4160),
    (2, 32, 32, 4161, 128, 4160),  # G = 1
    (2, 32, 4, 4161, 128, 4160),   # G = 8
    (1, 64, 2, 1000, 128, 999),    # G = 32: two row tiles
    (2, 8, 2, 777, 16, 700), (2, 8, 2, 777, 32, 776), (2, 16, 2, 1500, 64, 1499),
    (1, 32, 2, 4161, 128, 4159),   # B = 1: many splits
    (1, 32, 2, 4161, 128, 127), (1, 32, 2, 4161, 128, 128),  # a tile edge
    # PaliGemma's decode (G 8 on K 1, hd 256: 64-key tiles of 4 slices x 2
    # column halves; 8 real rows of the 16 carried)
    (2, 8, 1, 4161, 256, 4160), (2, 8, 1, 4161, 256, 63), (2, 8, 1, 4161, 256, 64),
    (1, 32, 1, 1000, 256, 999),    # G = 32 at hd 256: two row tiles
    (2, 8, 1, 4161, 256, 127), (2, 8, 1, 4161, 256, 128),  # a tile edge
    (2, 4, 1, 777, 256, 15), (2, 4, 1, 777, 256, 16),      # G = 4: one slice, then two
    # SeamlessM4T's decode step: G 1 on 16 kv heads at hd 64, its first
    # and last steps' pos
    (2, 16, 16, 4161, 64, 0), (2, 16, 16, 4161, 64, 1), (2, 16, 16, 4161, 64, 63),
]


@pytest.mark.parametrize("B,H,K,S,hd,pos", DECODE_CASES)
def test_kernel_arithmetic_keeps_one_step(B, H, K, S, hd, pos):
    (tq, tk, tv), _ = _inputs(B, H, K, S, hd, "bfloat16", seed=S + pos + H)
    want = ops.flash_decode(tq, tk, tv, pos)
    got = _decode_emulation(tq, tk, tv, pos)
    assert _misses(got, want) == 0
    assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -6


def test_split_edge_of_the_kernel():
    """pos on and past the first split's last position, for GLM-4-9B's
    decode at batch 8 (8 splits of 528 positions)."""
    assert _split_len(8 * 2, 4161) == 528
    (tq, tk, tv), _ = _inputs(8, 32, 2, 4161, 128, "bfloat16", seed=7)
    for pos in (527, 528):
        want = ops.flash_decode(tq, tk, tv, pos)
        assert _misses(_decode_emulation(tq, tk, tv, pos), want) == 0


@pytest.mark.parametrize("pos", [271, 272])
def test_split_edge_of_the_kernel_hd256(pos):
    """pos on and past the first split's last position, for PaliGemma's
    decode at batch 8 (16 splits of 272 positions, 5 tiles of 64)."""
    assert _split_len(8 * 1, 4161) == 272
    (tq, tk, tv), _ = _inputs(8, 8, 1, 4161, 256, "bfloat16", seed=pos)
    want = ops.flash_decode(tq, tk, tv, pos)
    assert _misses(_decode_emulation(tq, tk, tv, pos), want) == 0


def test_single_rounded_probabilities_would_miss():
    (tq, tk, tv), _ = _inputs(2, 32, 2, 4161, 128, "bfloat16", seed=4161 + 511 + 32)
    want = ops.flash_decode(tq, tk, tv, 511)
    assert _misses(_decode_emulation(tq, tk, tv, 511, split=False), want) > 0
