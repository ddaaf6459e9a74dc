"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's `repro.models.moe` under `jax.jit`.

The configs are the two MoE SMOKE configs (Qwen1.5-MoE: 6 experts top-2
with shared experts; Arctic: 8 experts top-2 with a dense residual FFN)
and variants whose `ep_axis` pads the experts (6 -> 8, 8 -> 9), so that
padded experts exist. Parameters are JAX's `init_moe` carried over bit
for bit; inputs come from numpy seeds.

- `_route`: idx bitwise, weights at rtol 1e-6 (the logits' product sums
  in torch's order); given JAX's logits, the weights bitwise (exp and
  the softmax's sum in XLA:CPU's order); crafted ties pick the lowest
  expert; padded experts are never routed to.
- The dispatch plan: `pos`, `keep` and `C` bitwise on JAX's routing at
  capacity factors 0.5, 1.25 and 8.0.
- `moe_dense` and `moe_capacity` at 2e-5 in float32 and 2e-2 in bf16.
- Given JAX's expert outputs, weights and plan, the combine is bitwise
  `jit(moe_capacity)`'s output, and a fused (single-rounded) combine is
  not.
- At capacity factor 8.0 nothing is dropped and capacity equals dense
  within 1e-4.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.numerics import fma_f32  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# (arch, ep_axis): None keeps the SMOKE config's own (no padded experts)
VARIANTS = [("qwen2_moe_a2_7b", None), ("qwen2_moe_a2_7b", 4), ("arctic_480b", None),
            ("arctic_480b", 3)]
IDS = [f"{a}-ep{ep or 'smoke'}" for a, ep in VARIANTS]
FACTORS = (0.5, 1.25, 8.0)
B, S = 4, 32  # 128 tokens


def _cfgs(arch, ep, dtype="float32"):
    jcfg, tcfg = jregistry.get_smoke_config(arch), registry.get_smoke_config(arch)
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    if ep:
        kw["ep_axis"] = ep
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _setup(arch, ep, dtype="float32", seed=0):
    jcfg, tcfg = _cfgs(arch, ep, dtype)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    tp = convert._tree(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed + 1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = convert._leaf(np.asarray(jx), "cpu")
    return jcfg, tcfg, jp, tp, jx, tx


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_plan(idx, E, C):
    """JAX's positions and drops (the lines of `moe_capacity`), jitted."""
    def f(idx):
        flat_e = idx.reshape(-1)
        onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot, flat_e[:, None],
                                  axis=1)[:, 0]
        return pos, pos < C
    return jax.jit(f)(idx)


def _jax_out_buf(jp, xt, jcfg, weights, idx, C):
    """JAX's expert buffers and expert outputs (the lines of
    `moe_capacity` before its combine), jitted."""
    cd = jnp.dtype(jcfg.compute_dtype)
    E = jp["router"].shape[1]

    def f(jp, xt, idx):
        T, D = xt.shape
        k = idx.shape[1]
        pos, keep = _jax_plan(idx, E, C)
        tok_of = jnp.repeat(jnp.arange(T), k)
        e_idx = jnp.where(keep, idx.reshape(-1), 0)
        c_idx = jnp.where(keep, pos, 0)
        vals = jnp.where(keep[:, None], xt[tok_of].astype(cd), 0)
        buf = jnp.zeros((E, C, D), cd).at[e_idx, c_idx].add(vals, mode="drop")
        return jmoe._expert_ffn(jp, buf, jcfg, cd)
    return jax.jit(f)(jp, xt, idx)


@pytest.mark.parametrize("arch,ep", VARIANTS, ids=IDS)
def test_route_matches_jax(arch, ep):
    jcfg, tcfg, jp, tp, jx, tx = _setup(arch, ep)
    xt = jx.reshape(-1, jcfg.d_model)
    jw, ji = jax.jit(lambda p, x: jmoe._route(p, x, jcfg))(jp, xt)
    tw, ti = moe._route(tp, tx.reshape(-1, tcfg.d_model), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
    assert int(ti.max()) < tcfg.n_experts


@pytest.mark.parametrize("arch,ep", VARIANTS, ids=IDS)
def test_route_weights_bitwise_given_jax_logits(arch, ep):
    """Softmax, top-k and renormalisation in XLA:CPU's rounding: from JAX's
    own logits the weights are JAX's bits (hazard 46)."""
    jcfg, tcfg, jp, tp, jx, tx = _setup(arch, ep)
    xt = jx.reshape(-1, jcfg.d_model)
    logits = jax.jit(lambda x, r: jnp.einsum("td,de->te", x.astype(jnp.float32), r))(
        xt, jp["router"])
    jw, ji = jax.jit(lambda p, x: jmoe._route(p, x, jcfg))(jp, xt)
    tw, ti = moe.route_logits(torch.from_numpy(np.array(logits)), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw).view(np.uint32))


@pytest.mark.parametrize("arch,ep", VARIANTS, ids=IDS)
def test_route_ties_pick_the_lowest_expert(arch, ep):
    """Equal logits: `lax.top_k` takes the lowest index first, and so does
    the port (a stable descending sort; hazard 45). A zero router ties
    every real expert; a router that raises every other expert by the
    same amount ties those."""
    jcfg, tcfg, jp, tp, jx, tx = _setup(arch, ep)
    E, n, k = jp["router"].shape[1], tcfg.n_experts, tcfg.n_experts_active
    xt = np.abs(np.asarray(jx.reshape(-1, jcfg.d_model)))
    for cols in (np.zeros(E, np.float32), (np.arange(E) % 2).astype(np.float32)):
        router = np.broadcast_to(cols, (jcfg.d_model, E)).copy()
        jw, ji = jax.jit(lambda r, x: jmoe._route({"router": r}, x, jcfg))(router, xt)
        tw, ti = moe._route({"router": torch.from_numpy(router)}, torch.from_numpy(xt), tcfg)
        want = np.arange(k) if not cols.any() else 1 + 2 * np.arange(k)
        assert (np.asarray(ji) == want).all()
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert want.max() < n


@pytest.mark.parametrize("arch,ep", [v for v in VARIANTS if v[1]],
                         ids=[i for i, v in zip(IDS, VARIANTS) if v[1]])
def test_padded_experts_are_never_routed(arch, ep):
    """A router that favours the padded experts above all still routes
    only to real ones, in both packages."""
    jcfg, tcfg, jp, tp, jx, tx = _setup(arch, ep)
    E, n = jp["router"].shape[1], tcfg.n_experts
    assert E > n
    router = np.array(jp["router"])
    router[:, n:] = 1e3
    xt = np.abs(np.asarray(jx.reshape(-1, jcfg.d_model)))
    jw, ji = jax.jit(lambda r, x: jmoe._route({"router": r}, x, jcfg))(router, xt)
    tw, ti = moe._route({"router": torch.from_numpy(router)}, torch.from_numpy(xt), tcfg)
    assert int(ti.max()) < n and int(np.asarray(ji).max()) < n
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("arch,ep", VARIANTS, ids=IDS)
def test_dispatch_plan_matches_jax(arch, ep, cf):
    """pos, keep and C bitwise on JAX's routing (hazard 47); drops at 0.5,
    none at 8.0."""
    jcfg, tcfg, jp, tp, jx, tx = _setup(arch, ep)
    xt = jx.reshape(-1, jcfg.d_model)
    T, k, E = xt.shape[0], tcfg.n_experts_active, jp["router"].shape[1]
    jw, ji = jax.jit(lambda p, x: jmoe._route(p, x, jcfg))(jp, xt)
    C = int(max(1, math.ceil(T * k * cf / E)))
    jpos, jkeep = _jax_plan(ji, E, C)
    plan = moe.dispatch_plan(torch.from_numpy(np.array(jw)), torch.from_numpy(np.array(ji)).long(),
                             E, cf)
    assert plan.C == C
    np.testing.assert_array_equal(plan.pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(plan.keep.numpy(), np.asarray(jkeep))
    dropped = int((~plan.keep).sum())
    if cf == 0.5:
        assert dropped > 0
    if cf == 8.0:
        assert dropped == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["dense", "capacity"])
@pytest.mark.parametrize("arch,ep", VARIANTS, ids=IDS)
def test_moe_matches_jax(arch, ep, path, dtype):
    jcfg, tcfg, jp, tp, jx, tx = _setup(arch, ep, dtype)
    if path == "dense":
        want = jax.jit(lambda p, x: jmoe.moe_dense(p, x, jcfg))(jp, jx)
        got = moe.moe_dense(tp, tx, tcfg)
    else:
        want = jax.jit(lambda p, x: jmoe.moe_capacity(p, x, jcfg))(jp, jx)
        got = moe.moe_capacity(tp, tx, tcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", (0.5, 1.25))
@pytest.mark.parametrize("arch,ep", VARIANTS, ids=IDS)
def test_combine_is_bitwise_given_jax_expert_outputs(arch, ep, cf, dtype):
    """JAX's expert outputs, weights and plan through the port's combine
    give `jit(moe_capacity)`'s output bit for bit: float32 from zero,
    slot 0 first, each product rounded (hazard 48). In float32 a fused
    combine (one rounding a slot) is shown to differ."""
    jcfg, tcfg, jp, tp, jx, tx = _setup(arch, ep, dtype)
    xt = jx.reshape(-1, jcfg.d_model)
    T, k, E = xt.shape[0], tcfg.n_experts_active, jp["router"].shape[1]
    C = int(max(1, math.ceil(T * k * cf / E)))
    jw, ji = jax.jit(lambda p, x: jmoe._route(p, x, jcfg))(jp, xt)
    out_buf = _jax_out_buf(jp, xt, jcfg, jw, ji, C)
    want = jax.jit(lambda p, x: jmoe.moe_capacity(p, x, jcfg, capacity_factor=cf))(jp, jx)
    plan = moe.dispatch_plan(torch.from_numpy(np.array(jw)), torch.from_numpy(np.array(ji)).long(),
                             E, cf)
    tbuf = convert._leaf(np.asarray(out_buf), "cpu")
    got = moe.combine(tbuf, plan, tx.dtype).reshape(tx.shape)
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    np.testing.assert_array_equal(got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
                                  .numpy().view(bits),
                                  np.asarray(want).view(bits))
    if dtype == "float32":
        rows = torch.where(plan.keep, plan.idx.reshape(-1) * C + plan.pos, 0).view(T, k)
        w = (plan.weights.reshape(-1) * plan.keep.float()).view(T, k)
        flat = tbuf.reshape(E * C, -1)
        fused = torch.zeros_like(got.reshape(T, -1))
        for j in range(k):
            fused = fma_f32(flat.index_select(0, rows[:, j]), w[:, j, None], fused)
        assert not torch.equal(fused, got.reshape(T, -1))


@pytest.mark.parametrize("arch,ep", VARIANTS, ids=IDS)
def test_capacity_at_factor_8_equals_dense(arch, ep):
    jcfg, tcfg, jp, tp, jx, tx = _setup(arch, ep)
    cap = moe.moe_capacity(tp, tx, tcfg, capacity_factor=8.0)
    dense = moe.moe_dense(tp, tx, tcfg)
    np.testing.assert_allclose(cap.numpy(), dense.numpy(), rtol=1e-4, atol=1e-4)


def test_decode_capacity_is_one_at_qwen_full_size():
    """Hazard 50: a decode step of batch 8 at Qwen1.5-MoE's full size (k 4,
    64 padded experts) has capacity 1, and its dropped pairs are those
    that share an expert within the step."""
    cfg = registry.get_config("qwen2_moe_a2_7b")
    E = moe.padded_expert_count(cfg.n_experts, cfg.ep_axis)
    assert E == 64
    assert moe.capacity(8, cfg.n_experts_active, E, cfg.moe_capacity_factor) == 1
    assert moe.capacity(8 * 4096, cfg.n_experts_active, E, cfg.moe_capacity_factor) == 2560
    idx = torch.tensor([[0, 1, 2, 3], [1, 4, 5, 6], [7, 0, 8, 9]])
    plan = moe.dispatch_plan(torch.full((3, 4), 0.25), idx, E, cfg.moe_capacity_factor)
    assert plan.C == 1
    assert plan.keep.tolist() == [True] * 4 + [False] + [True] * 3 + [True, False, True, True]


@pytest.mark.parametrize("arch", registry.MOE_ARCHS)
def test_ffn_sums_round_each_add_in_bf16(arch):
    """Hazard 49: in bf16 the JAX block adds moe + shared, then +
    dense_res, each sum rounded to bf16, then the residual; given JAX's
    own parts, the port's adds (bf16 tensors, one rounding an add) give
    the fused `jit` block's bits, and one float32 chain does not."""
    from repro.models import layers as jlayers
    from repro.models import transformer as jtransformer

    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), param_dtype="bfloat16",
                               compute_dtype="bfloat16", moe_path="capacity")
    p = jtransformer._init_ffn(jax.random.PRNGKey(0), jcfg, 0, jnp.bfloat16)
    rng = np.random.default_rng(5)
    x, res = (jnp.asarray(rng.standard_normal((2, 24, jcfg.d_model)), jnp.bfloat16)
              for _ in range(2))
    want = jax.jit(lambda p, x, r: r + jtransformer._apply_ffn(p, x, jcfg))(p, x, res)
    parts = [jax.jit(lambda q, x: jmoe.apply_moe(q, x, jcfg))(p["moe"], x)]
    parts += [jax.jit(lambda q, x: jlayers.apply_mlp(q, x, jcfg.activation, "bfloat16"))(p[n], x)
              for n in ("shared", "dense_res") if n in p]
    assert len(parts) == 2
    tparts = [convert._leaf(np.asarray(q), "cpu") for q in parts]
    y = tparts[0]
    for q in tparts[1:]:
        y = y + q
    got = convert._leaf(np.asarray(res), "cpu") + y
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    chain = (convert._leaf(np.asarray(res), "cpu").float() + sum(q.float() for q in tparts))
    assert not torch.equal(chain.to(torch.bfloat16), got)
