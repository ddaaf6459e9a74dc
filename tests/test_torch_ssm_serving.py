"""The port's Mamba-2 (ssm family) serving path against the JAX package.

The JAX model's parameters (`build_model(cfg).init(PRNGKey(0))` for the
mamba2 SMOKE config: 2 layers, d_model 64, 8 heads of 16, d_state 16,
chunk 8) go through `convert.params_from_reference`; the prefill logits
and state caches, four teacher-forced decode steps (logits, "ssm",
"conv") and the greedy tokens are held against the JAX package under
`jax.jit` and `repro.launch.serve.greedy_generate`.

Tolerances: 2e-5 in f32 and 2e-2 in bf16 (tests/test_kernels.py's; one
config with param and compute dtype bfloat16); greedy tokens equal in
f32; the port's prefill(S) + decode against its prefill(S + 1) at
tests/test_consistency.py's 2e-3; mamba2-1.3B's full layer width at 1e-4
(the reason is at the test). The SSD intra-chunk step runs through its
plain version, as every CPU tensor does.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch.serve import greedy_generate as jax_greedy  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2_1_3b"
B, S, STEPS = 2, 21, 4  # S: two whole chunks of 8 and a ragged one


def tol(dtype):
    return {"bfloat16": dict(rtol=2e-2, atol=2e-2), "full width": dict(rtol=1e-4, atol=1e-4)}.get(
        dtype, dict(rtol=2e-5, atol=2e-5))


def _pair(dtype="float32"):
    jcfg = jregistry.get_smoke_config(ARCH)
    tcfg = registry.get_smoke_config(ARCH)
    if dtype != "float32":
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype, compute_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, param_dtype=dtype, compute_dtype=dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def _assert_cache(tc, jc, dtype, what):
    got, want = convert.cache_to_numpy(tc), convert.cache_to_numpy(jc)
    assert set(got) == set(want) == {"ssm", "conv"}, what
    for name in ("ssm", "conv"):
        assert got[name].shape == want[name].shape, (what, name)
        np.testing.assert_allclose(got[name], want[name], err_msg=f"{what} {name}", **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    jm, jp, tm, tp = _pair(dtype)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}))(jp, toks)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_size)
    assert tc["ssm"].dtype == torch.float32 and tc["conv"].dtype == tp["embed"].dtype
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill logits", **tol(dtype))
    _assert_cache(tc, jc, dtype, "prefill")
    decode = jax.jit(jm.decode_step)
    for step in range(STEPS):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)  # teacher-forced
        jl, jc = decode(jp, nxt, jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"decode {step} logits",
                                   **tol(dtype))
        _assert_cache(tc, jc, dtype, f"decode {step}")


def test_greedy_tokens_equal_jax():
    jm, jp, tm, tp = _pair()
    prompts = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    want = np.asarray(jax_greedy(jm, jp, jnp.asarray(prompts), 8, S + 9))
    got = greedy_generate(tm, tp, torch.from_numpy(prompts), 8, S + 9)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_backbone_matches_jax():
    """The SSM stack on embedded inputs, as the JAX training path runs it
    (full-sequence chunked scan, no state returned)."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer

    jm, jp, tm, tp = _pair()
    x = np.random.default_rng(3).standard_normal((B, S, tm.cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jtransformer.backbone(p, x, jm.cfg))(jp, x)
    got = transformer.backbone(tp, torch.from_numpy(x), tm.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("float32"))


def test_decode_continues_a_jax_cache():
    """decode_step on the JAX package's own prefill cache, carried over
    by convert.cache_from_reference, matches JAX's next step."""
    jm, jp, tm, tp = _pair()
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    _, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}))(jp, toks)
    nxt = toks[:, :1]
    tcache = convert.cache_from_reference(jax.tree.map(np.asarray, jc), "cpu")
    assert set(tcache) == {"ssm", "conv"} and tcache["ssm"].dtype == torch.float32
    jl, jc = jax.jit(jm.decode_step)(jp, nxt, jc)
    tl, tcache = tm.decode_step(tp, torch.from_numpy(nxt), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol("float32"))
    _assert_cache(tcache, jc, "float32", "decode after a JAX prefill")


@pytest.mark.parametrize("S0", [3, 8, 16, 21])
def test_prefill_then_decode_equals_longer_prefill(S0):
    """The port's prefill(S) + decode(token S) gives the logits of its
    prefill(S + 1): across chunk edges (8, 16) and at the shortest prompt."""
    _, _, tm, tp = _pair()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (B, S0 + 1)).astype(np.int32))
    _, cache = tm.prefill(tp, {"tokens": toks[:, :S0]})
    got, _ = tm.decode_step(tp, toks[:, S0:], cache)
    want, _ = tm.prefill(tp, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("S0", [1, 2])
def test_prompt_shorter_than_the_conv_state_raises(S0):
    _, _, tm, tp = _pair()
    with pytest.raises(ValueError, match="conv"):
        tm.prefill(tp, {"tokens": torch.zeros((1, S0), dtype=torch.int32)})


def test_config_and_cache_specs_match_jax():
    for getter in ("get_config", "get_smoke_config"):
        t, j = getattr(registry, getter)(ARCH), getattr(jregistry, getter)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), getter
        assert t.total_params() == j.total_params()
    # total_params leaves out the norms, conv_b and dt_bias: the init's
    # leaves hold 1,446,714,368
    assert registry.get_config(ARCH).total_params() == 1_446_205_440
    assert registry.SSM_ARCHS == (ARCH,)
    jspec = jax_build(jregistry.get_config(ARCH)).cache_specs(4161, 8)
    tspec = build_model(registry.get_config(ARCH), "cpu").cache_specs(4161, 8)
    assert set(tspec) == set(jspec) == {"ssm", "conv"}
    for name in ("ssm", "conv"):
        assert tspec[name][0] == tuple(jspec[name].shape), name
        assert str(tspec[name][1]).split(".")[-1] == str(jspec[name].dtype), name


def test_own_init_and_zero_cache():
    cfg = dataclasses.replace(registry.get_smoke_config(ARCH), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    m = build_model(cfg, "cpu")
    p1, p2 = m.init(torch.Generator().manual_seed(4)), m.init(torch.Generator().manual_seed(4))
    mp = p1["layers"]["mamba"]
    assert torch.equal(mp["in_proj"], p2["layers"]["mamba"]["in_proj"])
    assert mp["in_proj"].shape == (2, 64, 2 * 128 + 2 * 16 + 8) and mp["in_proj"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        assert mp[name].dtype == torch.float32 and mp[name].shape == (2, 8), name
    assert bool(((mp["A_log"] >= 0) & (mp["A_log"] <= np.log(16.0))).all())
    cache = m.init_cache(3, 10)
    assert cache["ssm"].shape == (2, 3, 8, 16, 16) and cache["ssm"].dtype == torch.float32
    assert cache["conv"].shape == (2, 3, 3, 160) and cache["conv"].dtype == torch.bfloat16
    logits, _ = m.decode_step(p1, torch.zeros((3, 1), dtype=torch.int32), cache)
    assert logits.shape == (3, 512) and torch.isfinite(logits).all()


def test_serve_cli_runs_on_the_cpu():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "4", "--batch", "2", "--prompt-len", "16",
         "--gen-len", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("batch 0: generated (2, 4)")
    assert lines[-1].startswith("served 4 reqs, 16 tokens on cpu")


def test_full_width_layers_match_jax():
    """mamba2-1.3B's layer width (d_model 2048, 64 heads of 64, d_state
    128, chunk 256) at 2 layers and a 512-token vocab, in f32: a
    300-token prefill (a whole chunk and a ragged one, the model's own
    strong decays) and one decode step. Tolerance 1e-4 (rtol and atol):
    at this width in_proj sums 2048 float32 products per output in
    another order than XLA's, and a chunk state sums up to 256 such
    terms; the SMOKE tests above hold 2e-5."""
    cfg = dataclasses.replace(registry.get_config(ARCH), n_layers=2, vocab_size=512,
                              param_dtype="float32", compute_dtype="float32")
    jcfg = jregistry.ModelConfig(**dataclasses.asdict(cfg))
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, "cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 301)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}))(jp, toks[:, :300])
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :300])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill logits", **tol("full width"))
    _assert_cache(tc, jc, "full width", "prefill")
    jl, jc = jax.jit(jm.decode_step)(jp, toks[:, 300:], jc)
    tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, 300:]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="decode logits", **tol("full width"))
    _assert_cache(tc, jc, "full width", "decode")
