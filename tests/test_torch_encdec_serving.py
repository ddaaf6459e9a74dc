"""The port's enc-dec family (SeamlessM4T) against the JAX package.

The JAX model's parameters (`build_model(cfg).init(PRNGKey(0))`: the
"encoder", decoder "layers" and "cross" stacks, untied embeddings) go
through `convert.params_from_reference`; the source is the speech
frontend stub's output, frame embeddings [B, source_len, D] drawn with
numpy from a seed and cast to the compute dtype on both sides. The
encoder's output, the teacher-forced decoder's output, the prefill (BOS
logits exactly 0 from a zero hidden state, the cross caches, zero self
caches, pos 0) and four teacher-forced decode steps (logits and every
cache) are held against the JAX functions under `jax.jit`, and the greedy
tokens against a greedy loop over JAX's jitted prefill and decode_step,
for SeamlessM4T's SMOKE config in f32 and in bf16. Tolerances are
tests/test_kernels.py's: 2e-5 in f32, 2e-2 in bf16. In bf16 the encoder's
output, the cross caches and the decode steps' layer-0 self caches are
also bitwise equal to JAX's: the sinusoidal table is jit's, the frames
and the embeddings take it in bf16 adds, and the norm after each residual
add reads its float32 sum (`layers.residual_norm`), as XLA:CPU fuses the
block. Attention (the encoder's full mask, the decoder's causal
self-attention, the cross-attention at Sq 1 and at the target's length)
runs through the kernels' plain versions, as every CPU tensor does.

Also here: the sinusoidal table bitwise against `jit(sinusoidal_positions)`
at every (S, d) the slice reads and the eager table's differences (the
hazard), the registry's config and cache specs against JAX's,
`params_from_reference` on an enc-dec tree, a decode step from a JAX
prefill's cache, the prefill's batch checks, and the serve CLI refusing
the enc-dec family as JAX's does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ARCH = "seamless_m4t_medium"
B, C, STEPS, S_TGT = 2, 40, 4, 12
DTYPES = ["float32", "bfloat16"]


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(dtype="float32"):
    overrides = {} if dtype == "float32" else dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jregistry.get_smoke_config(ARCH), **overrides)
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH), **overrides)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def _frames(cfg, seed, S=None):
    """The same source for both packages: (JAX frames, port frames)."""
    S = S or cfg.source_len
    f = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(f).astype(cfg.compute_dtype),
            torch.from_numpy(f).to(layers.dtype_of(cfg.compute_dtype)))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _close(got, want, dtype, what, bitwise=False):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, err_msg=what, **tol(dtype))
    if bitwise and dtype == "bfloat16":  # (the module docstring)
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{what} bitwise")


def _assert_cache(tc, jc, dtype, what):
    got, want = convert.cache_to_numpy(tc), convert.cache_to_numpy(jc)
    assert got["pos"] == want["pos"], what
    for name in ("k", "v", "ck", "cv"):
        _close(got[name], want[name], dtype, f"{what} {name}")
        _close(got[name][0], want[name][0], dtype, f"{what} layer 0 {name}", bitwise=True)


# --------------------------------------------------------------------------
# the sinusoidal table
# --------------------------------------------------------------------------

TABLE_SIZES = [(32, 64), (C, 64), (4096, 1024), (4161, 1024)]  # C: SMOKE's decode table


@pytest.mark.parametrize("S,d", TABLE_SIZES, ids=[f"S{s}-d{d}" for s, d in TABLE_SIZES])
def test_sinusoidal_positions_bitwise_equal_jit(S, d):
    """The table the JAX model reads inside its jitted prefill and decode
    (every input a constant: XLA folds it), bit for bit."""
    want = jax.jit(jlayers.sinusoidal_positions, static_argnums=(0, 1))(S, d)
    got = layers.sinusoidal_positions(S, d, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.shape == (S, d)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_eager_sinusoidal_table_differs_from_jit():
    """The hazard: called eagerly, JAX takes XLA's float32 exp polynomial
    for the frequencies (numerics.exp_xla), and 314,999 of the 4,194,304
    values at (4096, 1024) differ from jit's constant-folded table, which
    the model reads and the port follows."""
    eager = _bits(jlayers.sinusoidal_positions(4096, 1024))
    folded = _bits(jax.jit(jlayers.sinusoidal_positions, static_argnums=(0, 1))(4096, 1024))
    port = _bits(layers.sinusoidal_positions(4096, 1024, torch.device("cpu")).numpy())
    assert int((eager != folded).sum()) == 314_999
    np.testing.assert_array_equal(port, folded)


def test_sinusoidal_table_is_cached():
    a = layers.sinusoidal_positions(48, 64, torch.device("cpu"))
    assert layers.sinusoidal_positions(48, 64, torch.device("cpu")) is a


# --------------------------------------------------------------------------
# the model against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_forward_matches_jax(dtype):
    jm, jp, tm, tp = _pair(dtype)
    cfg = tm.cfg
    jf, tf = _frames(cfg, seed=1)
    want = jax.jit(lambda p, f: jtransformer.encoder_forward(p, f, jm.cfg))(jp, jf)
    got = transformer.encoder_forward(tp, tf, cfg)
    assert got.dtype == layers.dtype_of(cfg.compute_dtype) and got.shape == tuple(want.shape)
    _close(got.float().numpy(), want, dtype, "encoder output", bitwise=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decoder_forward_encdec_matches_jax(dtype):
    """The teacher-forced decoder (causal self-attention at S_TGT, the
    cross-attention at S_TGT queries against the source) over JAX's
    encoder output."""
    jm, jp, tm, tp = _pair(dtype)
    cfg = tm.cfg
    jf, _ = _frames(cfg, seed=2)
    enc = jax.jit(lambda p, f: jtransformer.encoder_forward(p, f, jm.cfg))(jp, jf)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S_TGT)).astype(np.int32)
    want = jax.jit(lambda p, t, e: jtransformer.decoder_forward_encdec(p, t, e, jm.cfg))(
        jp, toks, enc)
    t_enc = torch.from_numpy(np.array(enc, np.float32)).to(layers.dtype_of(cfg.compute_dtype))
    got = transformer.decoder_forward_encdec(tp, torch.from_numpy(toks), t_enc, cfg)
    assert got.shape == (B, S_TGT, cfg.d_model)
    _close(got.float().numpy(), want, dtype, "decoder output", bitwise=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_jax(dtype):
    jm, jp, tm, tp = _pair(dtype)
    cfg = tm.cfg
    jf, tf = _frames(cfg, seed=4)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=C))(jp, {"frames": jf})
    tl, tc = tm.prefill(tp, {"frames": tf}, cache_len=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_size)
    assert not bool(tl.any()) and not np.asarray(jl).any()  # BOS logits exactly 0
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    assert tc["k"].shape == (cfg.n_layers, B, C, K, hd) and not bool(tc["k"].any())
    assert not bool(tc["v"].any()) and int(tc["pos"]) == 0
    assert tc["ck"].shape == (cfg.n_layers, B, cfg.source_len, K, hd)
    _assert_cache(tc, jc, dtype, "prefill")
    decode = jax.jit(jm.decode_step)
    rng = np.random.default_rng(5)
    for step in range(STEPS):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)  # teacher-forced
        jl, jc = decode(jp, nxt, jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        _close(tl.numpy(), jl, dtype, f"decode {step} logits")
        _assert_cache(tc, jc, dtype, f"decode {step}")


def test_prefill_of_a_longer_source_and_default_cache():
    """frames of another length than source_len (the cross caches take
    the frames' length), and the self cache's default capacity
    source_len, as JAX's prefill sizes it."""
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    jf, tf = _frames(cfg, seed=6, S=cfg.source_len + 13)
    jl, jc = jax.jit(jm.prefill)(jp, {"frames": jf})
    tl, tc = tm.prefill(tp, {"frames": tf})
    assert tc["k"].shape[2] == cfg.source_len and tc["ck"].shape[2] == cfg.source_len + 13
    _assert_cache(tc, jc, "float32", "prefill")
    nxt = np.full((B, 1), 7, np.int32)
    jl, jc = jax.jit(jm.decode_step)(jp, nxt, jc)
    tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
    _close(tl.numpy(), jl, "float32", "decode logits")


def test_decode_from_a_jax_prefill():
    """cache_from_reference carries the enc-dec cache (self and cross
    caches, pos) over; a decode step from it matches JAX's."""
    jm, jp, tm, tp = _pair()
    jf, _ = _frames(tm.cfg, seed=7)
    _, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=C))(jp, {"frames": jf})
    tc = convert.cache_from_reference(jax.tree.map(np.asarray, jc), "cpu")
    assert set(tc) == {"k", "v", "ck", "cv", "pos"} and tc["pos"].dtype == torch.int32
    nxt = np.array([[3], [11]], np.int32)
    jl, jc = jax.jit(jm.decode_step)(jp, nxt, jc)
    tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
    _close(tl.numpy(), jl, "float32", "decode logits")
    _assert_cache(tc, jc, "float32", "decode after a JAX prefill")


def test_greedy_tokens_equal_jax():
    jm, jp, tm, tp = _pair()
    jf, tf = _frames(tm.cfg, seed=8)
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=C))(jp, {"frames": jf})
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = []
    for _ in range(C):
        want.append(np.asarray(tok))
        logits, cache = decode(jp, tok, cache)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    logits, cache = tm.prefill(tp, {"frames": tf}, cache_len=C)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    got = []
    for _ in range(C):
        got.append(tok)
        logits, cache = tm.decode_step(tp, tok, cache)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    got = torch.cat(got, dim=1)
    assert got.dtype == torch.int32 and not bool(got[:, 0].any())  # the first token is 0
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


# --------------------------------------------------------------------------
# configs, specs, parameters, refusals
# --------------------------------------------------------------------------

def test_configs_and_cache_specs_match_jax():
    assert registry.ENCDEC_ARCHS == (ARCH,) and ARCH not in registry.NOT_PORTED
    for getter in ("get_config", "get_smoke_config"):
        t, j = getattr(registry, getter)(ARCH), getattr(jregistry, getter)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.total_params() == j.total_params()
    cfg = registry.get_config(ARCH)
    jm = jax_build(jregistry.get_config(ARCH))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jm.param_specs()))
    assert n == 877_156_352  # jax.eval_shape of init at full size
    jspec = jm.cache_specs(4161, 8)
    tspec = build_model(cfg, "cpu").cache_specs(4161, 8)
    assert set(tspec) == set(jspec) == {"k", "v", "ck", "cv", "pos"}
    for name in tspec:
        assert tspec[name][0] == tuple(jspec[name].shape), name
        assert str(tspec[name][1]).split(".")[-1] == str(jspec[name].dtype), name
    cache = build_model(registry.get_smoke_config(ARCH), "cpu").init_cache(3, 10)
    assert cache["k"].shape == (2, 3, 10, 4, 16) and cache["ck"].shape == (2, 3, 32, 4, 16)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_from_reference_on_an_encdec_tree(dtype):
    """The port's own init has JAX's names, shapes and dtypes (encoder,
    cross and decoder stacks, an unembed leaf), params_from_reference
    carries JAX's tree over bit for bit, and a tree without the encoder
    stack, or an enc-dec tree for a decoder-only config, is refused."""
    jcfg = dataclasses.replace(jregistry.get_smoke_config(ARCH), param_dtype=dtype,
                               compute_dtype=dtype)
    tcfg = registry.ModelConfig(**dataclasses.asdict(jcfg))
    jm = jax_build(jcfg)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(jm.param_specs()).items()}
    own = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _flat(own).items()} == want
    assert "/encoder/attn/wq" in want and "/cross/ln/bias" in want and "/unembed" in want
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = convert.params_from_reference(jp, tcfg, "cpu")
    flat_j = _flat(jp)
    for k, v in _flat(tp).items():
        np.testing.assert_array_equal(v.float().numpy(), np.asarray(flat_j[k]).astype(np.float32))
    with pytest.raises(ValueError, match="is_encoder_decoder"):
        convert.params_from_reference({k: v for k, v in jp.items() if k != "encoder"}, tcfg,
                                      "cpu")
    dense = dataclasses.replace(tcfg, family="dense", is_encoder_decoder=False)
    with pytest.raises(ValueError, match="is_encoder_decoder"):
        convert.params_from_reference(jp, dense, "cpu")


def test_prefill_refuses_a_bad_batch():
    _, _, tm, tp = _pair()
    _, tf = _frames(tm.cfg, seed=9)
    with pytest.raises(ValueError, match="frames"):
        tm.prefill(tp, {"tokens": torch.zeros((B, 4), dtype=torch.int32)})
    for bad in (tf[..., :-1], tf[0], tf[:, :0], tf.to(torch.int32), tf[None]):
        with pytest.raises(ValueError, match="frames"):
            tm.prefill(tp, {"frames": bad})
    with pytest.raises(ValueError, match="frames"):  # not on the parameters' device
        tm.prefill(tp, {"frames": tf.to("meta")})
    # any float dtype is cast to the compute dtype, as JAX casts it
    _, c32 = tm.prefill(tp, {"frames": tf})
    _, c64 = tm.prefill(tp, {"frames": tf.double()})
    assert torch.equal(c32["ck"], c64["ck"]) and torch.equal(c32["cv"], c64["cv"])


def test_serve_cli_refuses_encdec():
    """As the JAX package's CLI (`repro.launch.serve`) does: decoder-only LMs."""
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
