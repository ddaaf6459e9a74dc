"""The port's data pipeline against the JAX package's.

`repro_torch.random.bernoulli` is held bitwise against
`jax.random.bernoulli` (p 0.15, the stream's, and the edges 0 and 1);
`TokenStream.batch(step)` and `make_batch_fn` bitwise against
`repro.data.pipeline` for steps 0-3 at vocab 512 (the SMOKE configs) and
151,936 (Qwen1.5's), for a dense config, a vlm (its "patches" drawn by the
twin's `normal` times 0.02) and an enc-dec config (its "frames"), as the
JAX package draws them eagerly; `shard_for_host` and `TaskArrivals` (numpy
in both) equal. Tokens and labels are integers, so nothing here has a
tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")

from repro.configs import registry as jregistry  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import TaskArrivals, TokenStream, make_batch_fn  # noqa: E402


@pytest.mark.parametrize("p", [0.15, 0.0, 1.0, 0.5])
@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_bernoulli_bitwise(p, seed):
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, (37, 130)))
    got = jr.bernoulli(jr.PRNGKey(seed, "cpu"), p, (37, 130))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def _same(got, want):
    assert set(got) == set(want)
    for name, x in want.items():
        w = np.asarray(x)
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.view(np.uint32) if g.dtype == np.float32 else g,
                                      w.view(np.uint32) if w.dtype == np.float32 else w,
                                      err_msg=name)


@pytest.mark.parametrize("vocab", [512, 151936])
def test_token_stream_bitwise(vocab):
    j = jpipe.TokenStream(vocab, 80, 4, seed=5)
    t = TokenStream(vocab, 80, 4, seed=5, device="cpu")
    for step in range(4):
        b = t.batch(step)
        assert b["tokens"].dtype == torch.int32
        _same(b, j.batch(step))
        assert int(b["labels"][:, -1].max()) == -1


@pytest.mark.parametrize("arch,seq_len", [("qwen1_5_0_5b", 64), ("paligemma_3b", 24),
                                          ("seamless_m4t_medium", 32)])
def test_make_batch_fn_bitwise(arch, seq_len):
    jcfg = jregistry.get_smoke_config(arch)
    tcfg = registry.get_smoke_config(arch)
    if tcfg.is_encoder_decoder:  # a short source keeps the frames small
        jcfg = dataclasses.replace(jcfg, source_len=16)
        tcfg = dataclasses.replace(tcfg, source_len=16)
    jb = jpipe.make_batch_fn(jcfg, seq_len, 2, seed=1)
    tb = make_batch_fn(tcfg, seq_len, 2, seed=1, device="cpu")
    for step in range(4):
        _same(tb(step), jb(step))


def test_full_vocab_batch_at_qwen_width():
    """Qwen1.5-0.5B's vocab at a longer sequence: steps 0-3 bitwise."""
    cfg = registry.get_config("qwen1_5_0_5b")
    jb = jpipe.make_batch_fn(jregistry.get_config("qwen1_5_0_5b"), 512, 2, seed=0)
    tb = make_batch_fn(cfg, 512, 2, seed=0, device="cpu")
    for step in range(4):
        _same(tb(step), jb(step))


def test_shard_for_host():
    j = jpipe.TokenStream(512, 16, 8, seed=2)
    t = TokenStream(512, 16, 8, seed=2, device="cpu")
    jb, tb = j.batch(3), t.batch(3)
    for host in range(4):
        _same(t.shard_for_host(tb, host, 4), j.shard_for_host(jb, host, 4))
    with pytest.raises(ValueError, match="split"):
        t.shard_for_host(tb, 0, 3)


@pytest.mark.parametrize("M,amax,seed", [(5, 400, 0), (2, 2, 7), (9, 10, 3)])
def test_task_arrivals(M, amax, seed):
    j, t = jpipe.TaskArrivals(M, amax, seed), TaskArrivals(M, amax, seed)
    for step in (0, 1, 17, 1999):
        got, want = t(step), j(step)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_stream_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenStream(512, 8, 2).batch(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch_fn(registry.get_smoke_config("qwen1_5_0_5b"), 8, 2)
