"""The port's GreenOrchestrator against the JAX package's.

On tests/test_orchestrator.py's setup (two SMOKE jobs, Qwen1.5 and
InternLM2, float32, seq 32, batch 2, one step a task, AdamW lr 1e-3,
M2 x N2, CarbonIntensityPolicy(V=0.01), 8 slots, 3 tasks a cloud a slot),
both packages run from the same parameters (`convert.params_from_reference`):
every slot's action (d, w), the queues Qe and Qc and the executed count
bitwise, the cumulative emissions at rtol 1e-6 (numpy sums on the host in
both), each job's losses at rtol 1e-5 (float32 steps: the sums run in
another order). Then tests/test_orchestrator.py's properties in the port:
restart bit-exact, rerouting after a cloud fails, zero capacity for a
dead cloud, the slowdown helpers, the busy cloud not marked a straggler,
and the carbon-aware policy emitting less per task than the queue-length
baseline under the UK trace. `lm_task_energy_kwh` and `lm_workloads`
equal JAX's when given JAX's TPU constants, which live only here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")

from repro.configs import paper_workloads as jworkloads  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core.carbon import ConstantCarbonSource as JaxConstant  # noqa: E402
from repro.core.policies import CarbonIntensityPolicy as JaxCarbonPolicy  # noqa: E402
from repro.core.queueing import NetworkSpec as JaxSpec  # noqa: E402
from repro.data.pipeline import make_batch_fn as jax_batch_fn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.optim.adamw import make_train_step as jax_train_step  # noqa: E402
from repro.orchestrator import green as jgreen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import paper_workloads, registry  # noqa: E402
from repro_torch.core.carbon import ConstantCarbonSource, UKRegionalTraceSource  # noqa: E402
from repro_torch.core.policies import CarbonIntensityPolicy, QueueLengthPolicy  # noqa: E402
from repro_torch.core.queueing import NetworkSpec  # noqa: E402
from repro_torch.data import make_batch_fn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW, make_train_step  # noqa: E402
from repro_torch.orchestrator import Cloud, GreenOrchestrator, TrainJob  # noqa: E402
from repro_torch.pytree import tree_leaves  # noqa: E402

NAMES = ("qwen1_5_0_5b", "internlm2_20b")
SPEC = dict(pe=np.full(2, 1.0, np.float32), pc=np.full((2, 2), 5.0, np.float32), Pe=8.0,
            Pc=np.full(2, 20.0, np.float32))


def arrivals(t):
    rng = np.random.default_rng((7, t))
    return rng.integers(0, 3, 2).astype(np.float32)


def _jax_params(i):
    jm = jax_build(jregistry.get_smoke_config(NAMES[i]))
    return jm, jm.init(jax.random.PRNGKey(i))


def make_jobs(from_jax=False):
    jobs = []
    for i, aid in enumerate(NAMES):
        cfg = registry.get_smoke_config(aid)
        model = build_model(cfg, "cpu")
        opt = AdamW(lr=1e-3)
        if from_jax:
            params = convert.params_from_reference(jax.tree.map(np.asarray, _jax_params(i)[1]),
                                                   cfg, "cpu")
        else:
            params = model.init(torch.Generator().manual_seed(i))
        jobs.append(TrainJob(name=aid, model=model, train_step=make_train_step(model, opt),
                             batch_fn=make_batch_fn(cfg, 32, 2, seed=i, device="cpu"),
                             params=params, opt_state=opt.init(params), steps_per_task=1))
    return jobs


def make_orch(jobs=None, **kw):
    kw = dict(dict(carbon_source=ConstantCarbonSource(N=2), arrival_fn=arrivals), **kw)
    return GreenOrchestrator(jobs=jobs or make_jobs(), clouds=kw.pop("clouds", None)
                             or [Cloud("c0"), Cloud("c1")], spec=NetworkSpec(**SPEC),
                             device="cpu", **kw)


def _recording(policy, out, host):
    def run(*args):
        act = policy(*args)
        out.append((host(act.d), host(act.w)))
        return act
    return run


def test_schedule_matches_jax():
    jjobs = []
    for i, aid in enumerate(NAMES):
        jm, jp = _jax_params(i)
        opt = JaxAdamW(lr=1e-3)
        jjobs.append(jgreen.TrainJob(name=aid, model=jm, train_step=jax.jit(jax_train_step(jm, opt)),
                                     batch_fn=jax_batch_fn(jm.cfg, 32, 2, seed=i), params=jp,
                                     opt_state=opt.init(jp), steps_per_task=1))
    jact, tact = [], []
    jorch = jgreen.GreenOrchestrator(
        jobs=jjobs, clouds=[jgreen.Cloud("c0"), jgreen.Cloud("c1")], spec=JaxSpec(**SPEC),
        carbon_source=JaxConstant(N=2, Ce=10.0, Cc=10.0), arrival_fn=arrivals,
        policy=_recording(JaxCarbonPolicy(V=0.01), jact, np.asarray), max_tasks_per_slot=3)
    torch_orch = make_orch(make_jobs(from_jax=True),
                           carbon_source=ConstantCarbonSource(N=2, Ce=10.0, Cc=10.0),
                           policy=_recording(CarbonIntensityPolicy(V=0.01), tact,
                                             lambda x: x.numpy()),
                           max_tasks_per_slot=3)
    jhist, thist = jorch.run(8), torch_orch.run(8)
    assert len(jact) == len(tact) == 8
    for (jd, jw), (td, tw) in zip(jact, tact):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(torch_orch.state.Qe.numpy(), np.asarray(jorch.state.Qe))
    np.testing.assert_array_equal(torch_orch.state.Qc.numpy(), np.asarray(jorch.state.Qc))
    assert torch_orch.executed_tasks == jorch.executed_tasks > 0
    assert [h["executed"] for h in thist] == [h["executed"] for h in jhist]
    np.testing.assert_allclose(torch_orch.cum_emissions_trace, jorch.cum_emissions_trace,
                               rtol=1e-6)
    for tj, jj in zip(torch_orch.jobs, jorch.jobs):
        assert tj.step == jj.step and len(tj.losses) == len(jj.losses) > 0
        np.testing.assert_allclose(tj.losses, jj.losses, rtol=1e-5)


def test_orchestrator_executes_and_accounts(tmp_path):
    orch = make_orch(carbon_source=ConstantCarbonSource(N=2, Ce=10.0, Cc=10.0),
                     policy=CarbonIntensityPolicy(V=0.01), ckpt_dir=str(tmp_path / "ck"),
                     ckpt_every=3, max_tasks_per_slot=3)
    orch.run(8)
    assert orch.executed_tasks > 0 and orch.cum_emissions > 0
    assert np.all(np.diff(np.asarray(orch.cum_emissions_trace)) >= 0)
    assert all(j.step > 0 and np.isfinite(j.losses).all() for j in orch.jobs)
    assert orch.ckpt.all_steps() == [3, 6]


def test_checkpoint_restart_bit_exact(tmp_path):
    carbon = ConstantCarbonSource(N=2, Ce=10.0, Cc=10.0)

    def fresh(ckdir):
        return make_orch(carbon_source=carbon, policy=CarbonIntensityPolicy(V=0.01),
                         ckpt_dir=ckdir, ckpt_every=2, max_tasks_per_slot=3)

    a = fresh(str(tmp_path / "a"))
    a.run(6)
    b1 = fresh(str(tmp_path / "b"))
    b1.run(4)
    b1.ckpt.wait()
    b2 = fresh(str(tmp_path / "b"))
    assert b2.resume() and b2.t == 4
    b2.run(2)
    assert b2.t == a.t and b2.executed_tasks == a.executed_tasks
    np.testing.assert_allclose(b2.cum_emissions, a.cum_emissions, rtol=1e-6)
    assert torch.equal(b2.state.Qe, a.state.Qe) and torch.equal(b2.state.Qc, a.state.Qc)
    for ja, jb in zip(a.jobs, b2.jobs):
        assert ja.step == jb.step
        for x, y in zip(tree_leaves(ja.params) + tree_leaves(ja.opt_state),
                        tree_leaves(jb.params) + tree_leaves(jb.opt_state)):
            assert torch.equal(x, y)


def test_cloud_failure_reroutes_work():
    orch = make_orch(carbon_source=ConstantCarbonSource(N=2, Ce=1.0, Cc=1.0),
                     policy=CarbonIntensityPolicy(V=0.001), max_tasks_per_slot=3)
    orch.run(3, fail_at={1: 1})
    assert not orch.clouds[1].alive
    before = orch.executed_tasks
    orch.run(3)
    assert orch.executed_tasks > before
    orch.join_cloud(1)
    assert float(np.asarray(orch._effective_spec().Pc)[1]) > 0


def test_dead_cloud_gets_zero_capacity():
    orch = make_orch(clouds=[Cloud("c0"), Cloud("c1", alive=False)])
    assert float(np.asarray(orch._effective_spec().Pc)[1]) == 0.0


def test_slowdown_denominator_scales_with_expected_tasks():
    assert GreenOrchestrator._slowdown(2.0, 1.0, 4.0) == pytest.approx(0.5)
    assert GreenOrchestrator._slowdown(8.0, 1.0, 4.0) == pytest.approx(2.0)
    assert GreenOrchestrator._slowdown(0.5, 1.0, 0.25) == pytest.approx(0.5)


def test_busy_on_time_cloud_not_marked_straggler():
    orch = make_orch(policy=CarbonIntensityPolicy(V=0.001), max_tasks_per_slot=3,
                     slot_deadline_s=120.0)
    orch.run(4)
    assert orch.executed_tasks > 0
    for cloud in orch.clouds:
        assert cloud.measured_slowdown == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(np.asarray(orch._effective_spec().Pc), SPEC["Pc"])


def test_straggler_capacity_shrinks():
    orch = make_orch()
    orch.clouds[0].measured_slowdown = 2.0
    assert float(np.asarray(orch._effective_spec().Pc)[0]) == pytest.approx(SPEC["Pc"][0] / 2.0)


def test_carbon_aware_beats_queue_policy_in_orchestrator():
    carbon = UKRegionalTraceSource(N=2)

    def run(policy):
        orch = make_orch(carbon_source=carbon, policy=policy, max_tasks_per_slot=2)
        orch.run(12)
        return orch

    a, b = run(CarbonIntensityPolicy(V=0.5)), run(QueueLengthPolicy())
    assert (a.cum_emissions / max(a.executed_tasks, 1)
            < b.cum_emissions / max(b.executed_tasks, 1))


def test_lm_workloads_equal_jax_with_its_constants():
    kw = dict(peak_flops=jworkloads._V5E_PEAK, chip_kw=jworkloads._V5E_KW, mfu=jworkloads._MFU)
    ids = [a for a in jregistry.ARCH_IDS if a not in registry.NOT_PORTED]
    want, got = jworkloads.lm_workloads(ids), paper_workloads.lm_workloads(ids, **kw)
    for field in ("pe", "pc", "Pe", "Pc"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    assert paper_workloads.lm_workloads(**kw).M == len(ids)
    for n, tokens, steps in ((4.6e8, 32768, 100), (9.4e9, 4096, 1), (1e6, 1.0, 7)):
        assert (paper_workloads.lm_task_energy_kwh(n, tokens, steps, **kw)
                == jworkloads.lm_task_energy_kwh(n, tokens, steps))
    with pytest.raises(TypeError):
        paper_workloads.lm_task_energy_kwh(4.6e8, 32768)  # no TPU default


def test_orchestrator_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        GreenOrchestrator(jobs=make_jobs(), clouds=[Cloud("c0"), Cloud("c1")],
                          spec=NetworkSpec(**SPEC), carbon_source=ConstantCarbonSource(N=2),
                          arrival_fn=arrivals)
