"""The port's flash-attention plain version against the JAX package.

Inputs are made with numpy from a seed and handed to both packages (bf16
inputs rounded from the same float32 numbers on each side). The oracle
is `repro.kernels.ops.flash_attention_ref` over `tests/test_kernels.py`'s
sweep (MHA, GQA, MQA, rectangular, all three masks, f32 and bf16), plus
ragged Sq / Skv and Sq > Skv under causal; a few cases also go against
the Pallas kernel in interpret mode. PaliGemma's heads (hd 256, MQA at
K 1, G 8) run every mask, the prefix edge at 1, 255, 256 and 257, in f32
and bf16, against both. Tolerances are test_kernels.py's: 2e-5 in f32,
2e-2 in bf16. The CUDA kernel is held against this plain version on the
card by chip_smoke.py (phase 3c); its wrapper refuses a head dim that
neither route takes before anything is built.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa_module  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(B, H, K, Sq, Skv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd))]
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs], [jnp.asarray(a).astype(jdt) for a in arrs])


def _check(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol(dtype))


SWEEP = [
    (1, 4, 4, 128, 128, 64),   # MHA
    (2, 4, 2, 256, 256, 64),   # GQA 2:1
    (1, 8, 1, 128, 256, 32),   # MQA, rectangular
    (2, 2, 2, 64, 64, 128),    # small seq
    (1, 4, 2, 384, 256, 64),   # non-equal q/kv lens
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,K,Sq,Skv,hd", SWEEP)
@pytest.mark.parametrize("mode", ["causal", "full", "prefix"])
def test_plain_matches_reference_sweep(B, H, K, Sq, Skv, hd, mode, dtype):
    (tq, tk, tv), (jq, jk, jv) = _inputs(B, H, K, Sq, Skv, hd, dtype, seed=B * H + Sq)
    prefix = 32 if mode == "prefix" else 0
    got = ops.flash_attention(tq, tk, tv, mask_mode=mode, prefix_len=prefix)
    assert got.dtype == tq.dtype and got.shape == (B, H, Sq, hd)
    _check(got, jops.flash_attention_ref(jq, jk, jv, mask_mode=mode, prefix_len=prefix), dtype)


@pytest.mark.parametrize("B,H,K,Sq,Skv,hd,mode", [
    (1, 4, 2, 100, 37, 16, "causal"),
    (1, 4, 2, 100, 37, 16, "prefix"),
    (2, 6, 3, 77, 130, 32, "full"),
    (2, 6, 3, 77, 130, 32, "causal"),
    (1, 4, 2, 300, 100, 64, "causal"),   # Sq > Skv: late rows see every key
    (1, 2, 1, 1, 1, 16, "causal"),
    # SeamlessM4T's cross-attention: one query row (and a few) against
    # the source under the full mask, MHA at hd 64
    (2, 4, 4, 1, 1000, 64, "full"),
    (1, 4, 4, 2, 4095, 64, "full"),
    (1, 4, 4, 65, 1000, 64, "full"),
])
def test_plain_matches_reference_ragged(B, H, K, Sq, Skv, hd, mode):
    (tq, tk, tv), (jq, jk, jv) = _inputs(B, H, K, Sq, Skv, hd, "float32", seed=Sq * Skv)
    got = ops.flash_attention(tq, tk, tv, mask_mode=mode, prefix_len=20)
    _check(got, jops.flash_attention_ref(jq, jk, jv, mask_mode=mode, prefix_len=20), "float32")


@pytest.mark.parametrize("B,H,K,Sq,Skv,hd,bq,mode,dtype", [
    (1, 4, 2, 128, 128, 64, 64, "causal", "float32"),
    (1, 8, 1, 128, 256, 32, 64, "prefix", "bfloat16"),
    (2, 4, 2, 256, 256, 64, 128, "full", "float32"),
])
def test_plain_matches_pallas_interpret(B, H, K, Sq, Skv, hd, bq, mode, dtype):
    (tq, tk, tv), (jq, jk, jv) = _inputs(B, H, K, Sq, Skv, hd, dtype, seed=7)
    got = ops.flash_attention(tq, tk, tv, mask_mode=mode, prefix_len=32)
    want = jops.flash_attention(jq, jk, jv, mask_mode=mode, prefix_len=32, bq=bq, bk=bq,
                                interpret=True)
    _check(got, want, dtype)


# PaliGemma's attention: hd 256, MQA (H 8 on K 1), the prefix mask with
# its edge on either side of the kernels' 64-key tiles
HD256_MASKS = [("causal", 0), ("full", 0), ("prefix", 1), ("prefix", 255), ("prefix", 256),
               ("prefix", 257)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode,prefix", HD256_MASKS)
def test_plain_matches_reference_hd256(mode, prefix, dtype):
    B, H, K, S, hd = 1, 8, 1, 300, 256
    (tq, tk, tv), (jq, jk, jv) = _inputs(B, H, K, S, S, hd, dtype, seed=prefix + 256)
    got = ops.flash_attention(tq, tk, tv, mask_mode=mode, prefix_len=prefix)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, hd)
    _check(got, jops.flash_attention_ref(jq, jk, jv, mask_mode=mode, prefix_len=prefix), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode,prefix", [("prefix", 255), ("prefix", 257), ("causal", 0),
                                         ("full", 0)])
def test_plain_matches_pallas_interpret_hd256(mode, prefix, dtype):
    (tq, tk, tv), (jq, jk, jv) = _inputs(1, 8, 1, 256, 256, 256, dtype, seed=prefix + 7)
    got = ops.flash_attention(tq, tk, tv, mask_mode=mode, prefix_len=prefix)
    want = jops.flash_attention(jq, jk, jv, mask_mode=mode, prefix_len=prefix, bq=128, bk=128,
                                interpret=True)
    _check(got, want, dtype)


@pytest.mark.parametrize("hd", [48, 512])
def test_cuda_wrapper_refuses_other_head_dims_before_building(hd, monkeypatch):
    """A head dim that neither route takes raises ValueError from the
    checks, before the library is built or loaded."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(fa_module.build, "load", no_build)
    for dtype in DTYPES:
        (tq, tk, tv), _ = _inputs(1, 8, 1, 16, 16, hd, dtype, seed=hd)
        with pytest.raises(ValueError, match="hd"):
            fa_module.flash_attention_cuda(tq, tk, tv)
    assert 256 in fa_module.HEAD_DIMS and hd not in fa_module.HEAD_DIMS


def test_plain_matches_model_chunked_attention():
    """The contract the model serves with: the JAX model's query-chunked
    attention (grouped layout [B,S,K,G,hd]) equals the plain version."""
    from repro.models.layers import attention_scores_chunked

    B, H, K, S, hd = 2, 4, 2, 96, 32
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, S, K, H // K, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    want = attention_scores_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    mask_mode="causal", q_offset=0, chunk=32)
    tq = torch.from_numpy(q).reshape(B, S, H, hd).transpose(1, 2)
    got = ops.flash_attention(tq, torch.from_numpy(k).transpose(1, 2),
                              torch.from_numpy(v).transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).reshape(B, S, K, H // K, hd).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_query_chunking_changes_nothing(chunk, monkeypatch):
    (tq, tk, tv), _ = _inputs(1, 4, 2, 200, 150, 16, "float32", seed=3)
    whole = flash_attention_plain(tq, tk, tv, mask_mode="prefix", prefix_len=40)
    monkeypatch.setattr(fa_module, "QUERY_CHUNK", chunk)
    part = flash_attention_plain(tq, tk, tv, mask_mode="prefix", prefix_len=40)
    np.testing.assert_allclose(part.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


def test_bad_mask_mode_raises():
    (tq, tk, tv), _ = _inputs(1, 2, 1, 4, 4, 16, "float32", seed=0)
    with pytest.raises(ValueError, match="mask_mode"):
        ops.flash_attention(tq, tk, tv, mask_mode="sliding")


# --- why the bf16 CUDA kernel splits its probabilities ------------------
# csrc/flash_attention.cu runs P.V on bf16 tensor cores. These float32
# emulations of its online softmax (key tiles of `bk`, one tile at a time
# per row) show what rounding P to bf16 once would do against
# chip_smoke.py phase 3c's bf16 tolerance, and that the hi + lo split it
# uses stays inside it. A tile wholly masked for a row changes nothing
# (p = 0, alpha = 1), so skipping it, as attention_tc<256>'s lower
# warpgroup does, is the same arithmetic; the 128-row blocks touch no
# row's arithmetic either.

BF16_ATOL, BF16_RTOL = 1e-4, 2.0 ** -7  # chip_smoke.py ATTN_TOL: one bf16 rounding step


def _tiled_emulation(q, k, v, *, split, bk=128, mask_mode="causal", prefix_len=0):
    B, H, S, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, K, H // K, S, hd)
    s_all = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * (1.0 / np.sqrt(hd))
    q_pos, k_pos = torch.arange(S), torch.arange(Skv)
    if mask_mode != "full":
        mask = k_pos[None, :] <= q_pos[:, None]
        if mask_mode == "prefix":
            mask = mask | (k_pos[None, :] < prefix_len)
        s_all = torch.where(mask, s_all, -np.inf)
    m = torch.full(s_all.shape[:-1], -np.inf)
    l = torch.zeros(s_all.shape[:-1])
    o = torch.zeros(s_all.shape[:-1] + (hd,))
    for k0 in range(0, Skv, bk):
        s = s_all[..., k0:k0 + bk]
        m_new = torch.maximum(m, s.amax(-1))  # key 0 is in tile 0: never -inf
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        vt = v.float()[:, :, None, k0:k0 + bk]
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        o = alpha[..., None] * o + pv
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).reshape(B, H, S, hd).to(torch.bfloat16)


def _misses(got, want):
    diff = (got.float() - want.float()).abs()
    return int((diff > BF16_ATOL + BF16_RTOL * want.float().abs()).sum())


# (K, hd, key tile): the hd 128 instance's shape; PaliGemma's MQA heads at
# hd 256 over 64-key tiles and over attention_tc<256>'s 80-key tiles
SPLIT_CASES = [(2, 128, 128), (1, 256, 64), (1, 256, 80)]


def _split_case(K, hd):
    (tq, tk, tv), _ = _inputs(2, 8, K, 256, 256, hd, "bfloat16", seed=0)
    return tq, tk, tv, flash_attention_plain(tq, tk, tv)


@pytest.mark.parametrize("K,hd,bk", SPLIT_CASES)
def test_bf16_probabilities_would_miss_one_step(K, hd, bk):
    tq, tk, tv, want = _split_case(K, hd)
    assert _misses(_tiled_emulation(tq, tk, tv, split=False, bk=bk), want) > 1000


@pytest.mark.parametrize("K,hd,bk", SPLIT_CASES)
def test_split_probabilities_keep_one_step(K, hd, bk):
    tq, tk, tv, want = _split_case(K, hd)
    got = _tiled_emulation(tq, tk, tv, split=True, bk=bk)
    assert _misses(got, want) == 0
    assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -8


# attention_tc<256>'s edges (80-key tiles, 128-row blocks): Sq on either
# side of a block, the prefix edge on either side of a tile and of a
# block, Sq against a longer Skv
HD256_TILE_EDGES = [
    (127, 127, "causal", 0), (128, 128, "causal", 0), (129, 129, "causal", 0),
    (200, 200, "prefix", 79), (200, 200, "prefix", 80), (200, 200, "prefix", 81),
    (200, 200, "prefix", 160), (300, 300, "prefix", 127), (300, 300, "prefix", 129),
    (129, 250, "full", 0),
]


@pytest.mark.parametrize("Sq,Skv,mode,prefix", HD256_TILE_EDGES)
def test_split_probabilities_keep_one_step_hd256_edges(Sq, Skv, mode, prefix):
    (tq, tk, tv), _ = _inputs(1, 8, 1, Sq, Skv, 256, "bfloat16", seed=Sq + prefix)
    want = flash_attention_plain(tq, tk, tv, mask_mode=mode, prefix_len=prefix)
    got = _tiled_emulation(tq, tk, tv, split=True, bk=80, mask_mode=mode, prefix_len=prefix)
    assert _misses(got, want) == 0
    assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -8


# SeamlessM4T's shapes on the hd 64 instance (96-key tiles, 128-row
# blocks): the cross step's one query row and a few rows against the
# source, MHA, under the full mask; the split keeps them inside one step
ENCDEC_EDGES = [(1, 1000), (1, 4095), (2, 1000), (63, 1000), (65, 4095), (64, 4096)]


@pytest.mark.parametrize("Sq,Skv", ENCDEC_EDGES)
def test_split_probabilities_keep_one_step_encdec(Sq, Skv):
    (tq, tk, tv), _ = _inputs(1, 4, 4, Sq, Skv, 64, "bfloat16", seed=Sq + Skv)
    want = flash_attention_plain(tq, tk, tv, mask_mode="full")
    got = _tiled_emulation(tq, tk, tv, split=True, bk=96, mask_mode="full")
    assert _misses(got, want) == 0
    assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -8
