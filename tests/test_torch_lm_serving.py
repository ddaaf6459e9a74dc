"""The port's dense and MoE LM serving paths against the JAX package.

For each of the four dense SMOKE configs (GLM-4, Qwen1.5, InternLM2,
StarCoder2: GQA and MHA, partial and full rotary, QKV bias, tied
embeddings, LayerNorm + GELU and RMSNorm + SwiGLU) the JAX model's
parameters (`build_model(cfg).init(PRNGKey(0))`) go through
`convert.params_from_reference`; then the prefill logits and cache and
four teacher-forced decode steps (logits and caches) are held against
the JAX package under `jax.jit`, and the greedy tokens against
`repro.launch.serve.greedy_generate`. Tolerances are
tests/test_kernels.py's: 2e-5 in f32, 2e-2 in bf16 (param and compute
dtype bfloat16). In bf16 the layer-0 caches of the prefill and of each
decode step are also bitwise equal to JAX's: the port follows XLA:CPU's
rounding of rope (FMAs, glibc's sinf/cosf), silu, GELU and the residual
there (tests/test_torch_numerics_xla.py). Attention runs through the
kernels' plain versions, as every CPU tensor does.

The two MoE SMOKE configs (Qwen1.5-MoE with shared experts, Arctic with
its dense residual FFN) run the same checks as configured (the exact
dense MoE path) and through the capacity path (dispatch, drops,
combine).
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
B, S, C, STEPS = 2, 24, 32, 4


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(arch, dtype="float32", **overrides):
    jcfg = jregistry.get_smoke_config(arch)
    tcfg = registry.get_smoke_config(arch)
    if dtype != "float32":
        overrides.update(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jcfg, **overrides)
    tcfg = dataclasses.replace(tcfg, **overrides)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def _assert_cache(tc, jc, dtype, what):
    got, want = convert.cache_to_numpy(tc), convert.cache_to_numpy(jc)
    assert got["pos"] == want["pos"], what
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name], want[name], err_msg=f"{what} {name}", **tol(dtype))
        if dtype == "bfloat16":  # layer 0 bitwise (the module docstring)
            np.testing.assert_array_equal(got[name][0].view(np.uint32),
                                          want[name][0].view(np.uint32),
                                          err_msg=f"{what} layer 0 {name}")


def _prefill_and_decode(arch, dtype, **overrides):
    jm, jp, tm, tp = _pair(arch, dtype, **overrides)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=C))(jp, toks)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab_size)
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


@pytest.mark.parametrize("arch", registry.DENSE_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    _prefill_and_decode(arch, "float32")


@pytest.mark.parametrize("arch", registry.DENSE_ARCHS)
def test_prefill_and_decode_match_jax_bf16(arch):
    _prefill_and_decode(arch, "bfloat16")


@pytest.mark.parametrize("arch", registry.DENSE_ARCHS)
def test_greedy_tokens_equal_jax(arch):
    _greedy_tokens_equal_jax(arch)


def _greedy_tokens_equal_jax(arch, **overrides):
    jm, jp, tm, tp = _pair(arch, **overrides)
    prompts = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    want = np.asarray(jax_greedy(jm, jp, jnp.asarray(prompts), 8, C))
    got = greedy_generate(tm, tp, torch.from_numpy(prompts), 8, C)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# the MoE family: each SMOKE config as configured (moe_path "dense", the
# exact oracle) and through the production capacity path
MOE_CASES = [(arch, path) for arch in registry.MOE_ARCHS for path in ("dense", "capacity")]
MOE_IDS = [f"{arch}-{path}" for arch, path in MOE_CASES]


@pytest.mark.parametrize("arch,path", MOE_CASES, ids=MOE_IDS)
def test_moe_prefill_and_decode_match_jax(arch, path):
    _prefill_and_decode(arch, "float32", moe_path=path)


@pytest.mark.parametrize("arch,path", MOE_CASES, ids=MOE_IDS)
def test_moe_prefill_and_decode_match_jax_bf16(arch, path):
    _prefill_and_decode(arch, "bfloat16", moe_path=path)


@pytest.mark.parametrize("arch,path", MOE_CASES, ids=MOE_IDS)
def test_moe_greedy_tokens_equal_jax(arch, path):
    _greedy_tokens_equal_jax(arch, moe_path=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", registry.MOE_ARCHS)
def test_moe_params_match_jax_shapes(arch, dtype):
    """The port's own init has the shapes and dtypes of JAX's `eval_shape`
    (experts padded to ep_axis, here 4: Qwen's 6 -> 8; the router float32
    in a bf16 model), and `params_from_reference` carries JAX's MoE tree
    over leaf for leaf, refusing a router that does not fit."""
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), ep_axis=4,
                               param_dtype=dtype, compute_dtype=dtype)
    tcfg = registry.ModelConfig(**dataclasses.asdict(jcfg))
    jm = jax_build(jcfg)
    spec = jm.param_specs()
    own = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: tree}

    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in flat(spec).items()}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in flat(own).items()}
    assert got == want
    assert got["/layers/moe/router"][1] == "float32"
    E = -(-jcfg.n_experts // 4) * 4
    assert got["/layers/moe/w_in"][0][1] == E
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    for k, v in flat(tp).items():
        ref = np.asarray(flat(jp)[k])
        assert tuple(v.shape) == ref.shape
        np.testing.assert_array_equal(v.float().numpy(), ref.astype(np.float32))
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"]["moe"]["router"] = bad["layers"]["moe"]["router"][:, :, :-1]
    with pytest.raises(ValueError, match="router"):
        convert.params_from_reference(bad, tcfg, "cpu")


@pytest.mark.parametrize("arch", registry.DENSE_ARCHS)
def test_backbone_matches_jax(arch):
    """The decoder stack on embedded inputs, as the JAX training path
    runs it (full-sequence causal attention through the kernels' plain
    version)."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer

    jm, jp, tm, tp = _pair(arch)
    x = np.random.default_rng(3).standard_normal((B, S, tm.cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jtransformer.backbone(p, x, jm.cfg))(jp, x)
    got = transformer.backbone(tp, torch.from_numpy(x), tm.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("float32"))


def test_decode_continues_a_jax_cache():
    """decode_step on the JAX package's own prefill cache, carried over
    by convert.cache_from_reference, matches JAX's next step."""
    jm, jp, tm, tp = _pair("glm4_9b")
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    _, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=C))(jp, toks)
    nxt = toks[:, :1]
    tcache = convert.cache_from_reference(jax.tree.map(np.asarray, jc), "cpu")
    assert tcache["pos"].dtype == torch.int32 and int(tcache["pos"]) == S
    jl, jc = jax.jit(jm.decode_step)(jp, nxt, jc)
    tl, tcache = tm.decode_step(tp, torch.from_numpy(nxt), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol("float32"))
    _assert_cache(tcache, jc, "float32", "decode after a JAX prefill")


def test_configs_and_cache_specs_match_jax():
    for arch in registry.DENSE_ARCHS + registry.MOE_ARCHS:
        for getter in ("get_config", "get_smoke_config"):
            t, j = getattr(registry, getter)(arch), getattr(jregistry, getter)(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
            assert t.total_params() == j.total_params()
        cfg = registry.get_config(arch)
        jspec = jax_build(jregistry.get_config(arch)).cache_specs(4161, 8)
        tspec = build_model(cfg, "cpu").cache_specs(4161, 8)
        for name in ("k", "v", "pos"):
            assert tspec[name][0] == tuple(jspec[name].shape), (arch, name)
            assert str(tspec[name][1]).split(".")[-1] == str(jspec[name].dtype), (arch, name)
    assert registry.get_config("glm4_9b").total_params() == 9_399_435_264
    assert registry.get_config("qwen2_moe_a2_7b").total_params() == 14_315_487_232  # 60 experts; 64 padded are held
    assert set(registry.ARCH_IDS) == set(jregistry.ARCH_IDS)


def test_init_cache_and_own_init():
    m = build_model(registry.get_smoke_config("internlm2_20b"), "cpu")
    cache = m.init_cache(3, 10)
    assert cache["k"].shape == (2, 3, 10, 2, 16) and int(cache["pos"]) == 0
    p1, p2 = m.init(torch.Generator().manual_seed(4)), m.init(torch.Generator().manual_seed(4))
    assert torch.equal(p1["layers"]["attn"]["wq"], p2["layers"]["attn"]["wq"])
    assert p1["layers"]["mlp"]["w_in"].shape == (2, 64, 192)
    logits, _ = m.prefill(p1, {"tokens": torch.zeros((1, 5), dtype=torch.int32)}, cache_len=8)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b"])
def test_other_families_are_not_ported_yet(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.get_config(arch)
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.ModelConfig(**dataclasses.asdict(jcfg))
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg, "cpu")


@pytest.mark.parametrize("arch", ["seamless_m4t_medium"])
def test_encdec_family_builds_and_serves(arch):
    """The enc-dec config, not ported before its slice, comes from the
    registry as the JAX package's, and build_model serves it: a prefill
    of frame embeddings, then greedy decode steps (the first token 0,
    from the zero BOS logits)."""
    for getter in ("get_config", "get_smoke_config"):
        t, j = getattr(registry, getter)(arch), getattr(jregistry, getter)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cfg = registry.ModelConfig(**dataclasses.asdict(jregistry.get_smoke_config(arch)))
    m = build_model(cfg, "cpu")
    params = m.init(torch.Generator().manual_seed(1))
    frames = torch.randn((2, cfg.source_len, cfg.d_model), generator=torch.Generator().manual_seed(2))
    logits, cache = m.prefill(params, {"frames": frames}, cache_len=10)
    toks = []
    for _ in range(3):
        toks.append(torch.argmax(logits, dim=-1))
        logits, cache = m.decode_step(params, toks[-1][:, None].to(torch.int32), cache)
    toks = torch.stack(toks, dim=1)
    assert toks.shape == (2, 3) and not bool(toks[:, 0].any()) and int(cache["pos"]) == 3
    assert int(toks.max()) < cfg.vocab_size and torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "arctic_480b"])
def test_moe_families_build_and_serve(arch):
    """The two MoE configs, not ported before this slice, come from the
    registry as the JAX package's, and build_model serves both."""
    for getter in ("get_config", "get_smoke_config"):
        t, j = getattr(registry, getter)(arch), getattr(jregistry, getter)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cfg = registry.ModelConfig(**dataclasses.asdict(jregistry.get_smoke_config(arch)))
    m = build_model(cfg, "cpu")
    params = m.init(torch.Generator().manual_seed(1))
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(2),
                            dtype=torch.int32)
    toks = greedy_generate(m, params, prompts, 3, 10)
    assert toks.shape == (2, 3) and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


def test_moe_on_alternate_layers_is_not_ported_yet():
    """MoE every other layer (JAX stacks such layers in pairs; only the
    hybrid family uses it) is refused, naming the hybrid slice."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2_moe_a2_7b"), moe_every=2)
    with pytest.raises(NotImplementedError, match="3.3"):
        build_model(cfg, "cpu")


def _serve_cli(arch):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", "--requests", "4", "--batch", "2", "--prompt-len", "16",
         "--gen-len", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("batch 0: generated (2, 4)")
    assert lines[-1].startswith("served 4 reqs, 16 tokens on cpu")


def test_serve_cli_runs_on_the_cpu():
    _serve_cli("glm4_9b")


def test_serve_cli_serves_moe_on_the_cpu():
    _serve_cli("qwen2_moe_a2_7b")
