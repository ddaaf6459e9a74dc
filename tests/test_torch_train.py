"""The port's training path against the JAX package.

* `Model.loss` (`transformer.lm_loss`) and the gradient of every parameter
  leaf against `jax.value_and_grad(model.loss)` under `jit`, from the JAX
  model's parameters (`convert.params_from_reference`), for Qwen1.5 SMOKE
  (MHA, QKV bias, tied embeddings), GLM-4 SMOKE (GQA, partial rotary) and
  mamba2 SMOKE (the SSD step's backward, `ssd_chunk_intra_bwd_plain`),
  float32 and bf16. Tolerances: the loss rtol 1e-6 (f32) / 2e-3 (bf16);
  each leaf's gradient relative L2 2e-5 (f32) / 2e-2 (bf16: both packages
  round each op to bf16, at other places). A leaf whose gradient is all
  zero where JAX's is not fails on its own: that is the check that the
  attention kernel's autograd path reaches wq, wk, wv and their biases,
  and the SSD step's reaches A_log, D, dt_bias, conv_w, conv_b and
  gate_norm.
* Three `make_train_step` steps (Qwen1.5 and mamba2 SMOKE) from the same
  parameters and AdamWState
  (`convert.opt_state_from_reference`) with the cosine schedule: loss and
  grad_norm (f32 rtol 1e-5), lr bitwise, parameters (f32 max abs 2e-5,
  Adam's normalised steps move about 1e-3 a step; bf16 within the steps'
  own size: an element whose tiny gradient has the other sign moves the
  other way).
* The lr and the bias corrections bitwise against `jit` for steps 0-1000
  (ROADMAP hazard 63), and `numerics.fma_f32`'s derivative at float32
  midpoints (hazard 60).
* tests/test_runtime.py's AdamW quadratic and clipping tests, and the
  train CLI on the CPU: the loss falls, and a restart resumes exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.data.pipeline import make_batch_fn as jax_batch_fn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import make_batch_fn  # noqa: E402
from repro_torch.kernels.numerics import fma_f32  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import require_trainable  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule, make_train_step  # noqa: E402
from repro_torch.pytree import flatten_with_path, tree_leaves, tree_unflatten  # noqa: E402

B, S = 2, 32
GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(arch, dtype, **overrides):
    overrides.update(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), **overrides)
    tcfg = dataclasses.replace(registry.get_smoke_config(arch), **overrides)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu")
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], axis=1)
    labels[0, 5] = -1  # an ignored label inside the sequence
    return {"tokens": toks, "labels": labels}


def _f32(x):
    return np.asarray(x).astype(np.float32) if not torch.is_tensor(x) else x.float().numpy()


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "glm4_9b", "mamba2_1_3b"])
def test_loss_and_every_gradient_match_jax(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    batch = _batch(tm.cfg.vocab_size)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True))(jp)
    names, leaves = zip(*flatten_with_path(tp))
    leaves = [x.requires_grad_(True) for x in leaves]
    tl, tmet = tm.loss(tree_unflatten(tp, leaves),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.dtype == torch.float32 and float(tmet["tokens"]) == float(jmet["tokens"]) == B * S - 3
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=1e-6 if dtype == "float32" else 2e-3)
    grads = torch.autograd.grad(tl, leaves)
    jflat = jax.tree.leaves(jg)
    assert len(jflat) == len(grads)
    for name, g, w in zip(names, grads, jflat):
        assert g.dtype == leaves[names.index(name)].dtype
        got, want = _f32(g.detach()), _f32(w)
        if np.any(want != 0):
            assert np.any(got != 0), f"{name}: no gradient reached it"
        assert _rel_l2(got, want) <= GRAD_TOL[dtype], (name, _rel_l2(got, want))


def test_remat_changes_no_gradient():
    """remat "block" (layers under torch.utils.checkpoint) and "none"
    give the same loss and gradients, bit for bit."""
    _, _, tm, tp = _pair("glm4_9b", "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg.vocab_size).items()}
    out = []
    for remat in ("block", "none"):
        m = build_model(dataclasses.replace(tm.cfg, remat=remat), "cpu")
        leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(tp)]
        loss, _ = m.loss(tree_unflatten(tp, leaves), batch)
        out.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_chunked_loss_equals_one_chunk():
    """logit_chunk 8 (four chunks, recomputed in the backward) against one
    chunk of the whole sequence."""
    _, _, tm, tp = _pair("qwen1_5_0_5b", "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg.vocab_size).items()}
    res = []
    for chunk in (8, 2048, 13):
        m = build_model(dataclasses.replace(tm.cfg, logit_chunk=chunk), "cpu")
        leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(tp)]
        loss, _ = m.loss(tree_unflatten(tp, leaves), batch)
        res.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for other in res[1:]:
        for a, b in zip(res[0], other):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "mamba2_1_3b"])
def test_three_train_steps_match_jax(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 1, 10))
    topt = AdamW(lr=cosine_schedule(1e-3, 1, 10))
    js = jopt.init(jp)
    # a state that is not the zeros, so that carrying it over is tested
    js = js._replace(m=jax.tree.map(lambda x: x + 1e-6, js.m),
                     v=jax.tree.map(lambda x: x + 1e-4, js.v))
    ts = convert.opt_state_from_reference(jax.tree.map(np.asarray, js), "cpu")
    jstep, tstep = jax.jit(jadamw.make_train_step(jm, jopt)), make_train_step(tm, topt)
    jb = jax_batch_fn(jm.cfg, S, B, seed=3)
    tb = make_batch_fn(tm.cfg, S, B, seed=3, device="cpu")
    lr_sum = 0.0
    for step in range(3):
        jp, js, jmet = jstep(jp, js, jb(step))
        tp, ts, tmet = tstep(tp, ts, tb(step))
        assert float(tmet["lr"]) == float(jmet["lr"])
        lr_sum += float(tmet["lr"])
        rtol = 1e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=rtol)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=rtol)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    for (name, got), want in zip(flatten_with_path(tp), jax.tree.leaves(jp)):
        got, want = _f32(got), _f32(want)
        if dtype == "float32":
            assert np.abs(got - want).max() <= 2e-5, name
        else:  # Adam's steps are lr-sized whatever the gradient: a sign that differs moves 2 lr
            bound = 2 * 1.01 * lr_sum + 2.0 ** -8 * np.abs(want)
            assert np.all(np.abs(got - want) <= bound), name
    for a, b in zip(tree_leaves(ts.m), jax.tree.leaves(js.m)):
        assert a.dtype == torch.float32 and a.shape == np.shape(b)


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 20, 100), (1e-3, 0, 1000),
                                                (3e-4, 100, 1000), (6e-4, 7, 333)])
def test_schedule_and_bias_corrections_bitwise_against_jit(peak, warmup, total):
    steps = np.arange(0, 1001, dtype=np.int32)
    want = np.asarray(jax.jit(jadamw.cosine_schedule(peak, warmup, total))(steps))
    got = cosine_schedule(peak, warmup, total)(torch.from_numpy(steps)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    opt = AdamW()
    for b in (0.9, 0.95):
        jbc = np.asarray(jax.jit(lambda s, b=b: 1.0 - b ** s.astype(jnp.float32))(steps))
        tbc = opt._bias_correction(b, torch.from_numpy(steps)).numpy()
        np.testing.assert_array_equal(tbc.view(np.uint32), jbc.view(np.uint32))


def test_fma_f32_derivative_at_float32_midpoints():
    """bf16 x float32 products summed in float64 land on float32
    midpoints often; the derivative must still be (b, a, 1) there."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).bfloat16().requires_grad_()
    b = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    c = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).bfloat16().float()
         .requires_grad_())
    y = fma_f32(a, b, c)
    ga, gc = torch.autograd.grad(y.sum(), (a, c))
    assert torch.equal(ga, b.bfloat16()) and torch.equal(gc, torch.ones_like(c))
    with torch.no_grad():
        assert torch.equal(fma_f32(a, b, c), y)


def test_tree_walks_and_a_train_step_leave_no_reference_cycle():
    """With the cycle collector off, every tensor a tree walk or a train
    step saw is freed when the last reference goes: a walk that is a
    closure calling itself would keep its leaves in a cycle (on the card,
    a mamba2-1.3B step's parameters, moments and gradients)."""
    import gc
    import weakref

    _, _, tm, tp = _pair("mamba2_1_3b", "float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg.vocab_size).items()}
    opt = AdamW(lr=1e-3)
    step = make_train_step(tm, opt)
    step(tp, opt.init(tp), batch)  # the first checkpoint call imports torch._dynamo lazily
    gc.collect()
    gc.disable()
    try:
        state = opt.init(tp)
        new_p, new_s, _ = step(tp, state, batch)
        names, leaves = zip(*flatten_with_path((new_p, new_s)))
        refs = [weakref.ref(t) for t in tree_leaves(tree_unflatten((new_p, new_s), list(leaves)))]
        del new_p, new_s, names, leaves, state
        assert not [r for r in refs if r() is not None]
    finally:
        gc.enable()


def test_adamw_reduces_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_clipping_and_schedule():
    sched = cosine_schedule(1.0, warmup=10, total=100)
    assert float(sched(torch.tensor(0))) == 0.0
    assert abs(float(sched(torch.tensor(10))) - 1.0) < 1e-6
    assert float(sched(torch.tensor(100))) <= 0.2
    opt = AdamW(lr=0.1, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    new, state, metrics = opt.update({"w": torch.full((3,), 100.0)}, opt.init(params), params)
    assert float(metrics["grad_norm"]) > 100
    # clipped to norm 1, then Adam's first step moves each element by lr
    np.testing.assert_allclose(new["w"].numpy(), -0.1, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "paligemma_3b", "seamless_m4t_medium"])
def test_other_families_are_not_trainable_yet(arch):
    cfg = registry.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 3"):
        require_trainable(cfg)
    with pytest.raises(NotImplementedError, match="training"):
        build_model(cfg, "cpu").loss({}, {})


def test_train_cli_decreases_loss(tmp_path):
    from repro_torch.launch.train import main as train_main

    loss_end = train_main([
        "--arch", "qwen1_5_0_5b", "--smoke", "--steps", "60", "--seq-len", "64", "--batch", "4",
        "--lr", "3e-3", "--warmup", "5", "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu",
    ])
    assert loss_end < 5.9  # well below ln(512) = 6.24 at init


def test_train_cli_restart_resumes(tmp_path):
    from repro_torch.launch.train import main as train_main

    args = ["--arch", "qwen1_5_0_5b", "--smoke", "--seq-len", "32", "--batch", "2", "--lr", "1e-3",
            "--ckpt-every", "10", "--device", "cpu"]
    loss_full = train_main(args + ["--ckpt-dir", str(tmp_path / "a"), "--steps", "30"])
    train_main(args + ["--ckpt-dir", str(tmp_path / "b"), "--steps", "20"])
    loss_resumed = train_main(args + ["--ckpt-dir", str(tmp_path / "b"), "--steps", "30"])
    assert loss_full == loss_resumed  # the steps are deterministic on the CPU


def test_train_cli_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    from repro_torch.launch.train import main as train_main

    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "1"])
