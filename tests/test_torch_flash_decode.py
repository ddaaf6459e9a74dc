"""The port's flash-decode plain version against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
oracle is `repro.kernels.ops.flash_decode_ref` over `tests/test_kernels.py`'s
decode sweep, plus pos = 0, pos = S-1, a ragged S (the serving run's
4161) and G = 16 queries per kv head (GLM-4-9B's 32 on 2); two cases also
go against the Pallas kernel in interpret mode. Tolerances are
test_kernels.py's: 2e-5 in f32, 2e-2 in bf16. The CUDA kernel is held
against this plain version on the card by chip_smoke.py (phase 3c).
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


def test_positions_past_pos_are_ignored():
    """Changing the cache beyond pos changes nothing; pos may be an int."""
    (tq, tk, tv), _ = _inputs(1, 8, 2, 64, 16, "float32", seed=5)
    before = ops.flash_decode(tq, tk, tv, 40)
    tk[:, 41:] = 1e4
    tv[:, 41:] = -1e4
    after = ops.flash_decode(tq, tk, tv, torch.tensor(40, dtype=torch.int32))
    assert torch.equal(before, after)
