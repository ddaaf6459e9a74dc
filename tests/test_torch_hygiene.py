"""Boundaries of the PyTorch port.

* No module under src/repro_torch/, and not chip_smoke.py, imports jax
  or the JAX package `repro` (only these tests import both).
* Importing repro_torch loads no jax.
* The entry points default to the CUDA device and raise, rather than
  fall back to the CPU, where there is none.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.serve, repro_torch.convert, "
        "repro_torch.kernels.ops, repro_torch.kernels.build, repro_torch.configs.paper_workloads, "
        "repro_torch.network, repro_torch.configs.fleet_scenarios, repro_torch.models, "
        "repro_torch.launch.serve, repro_torch.configs.registry, repro_torch.configs.glm4_9b, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.flash_decode, "
        "repro_torch.kernels.ssd_chunk, repro_torch.kernels.numerics, repro_torch.models.mamba2, "
        "repro_torch.configs.mamba2_1_3b, repro_torch.random, repro_torch.kernels.threefry; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    from repro_torch.configs.paper_workloads import paper_spec
    from repro_torch.core import (
        CarbonIntensityPolicy,
        ConstantCarbonSource,
        UniformArrivals,
        init_state,
        materialize,
        simulate,
    )
    from repro_torch.configs.fleet_scenarios import build_fleet
    from repro_torch.convert import graph_from_numpy, spec_from_numpy
    from repro_torch.core import simulate_fleet, simulate_vsweep
    from repro_torch.core.queueing import drift_bound_B
    from repro_torch.random import PRNGKey
    from repro_torch.network import NetworkAwareDPPPolicy, direct_graph, init_links
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import Model, build_model
    from repro_torch.serve import serve_loop
    from repro_torch.serve.loop import main
    from repro_torch.telemetry import StreamConfig, TelemetryConfig, init_taps
    from repro_torch.core import ExactDPPPolicy, ThresholdPolicy
    from repro_torch.core.knapsack import bounded_knapsack_min, bounded_knapsack_min_batch
    from repro_torch import analysis
    from repro_torch.analysis import __main__ as analysis_cli

    args = (CarbonIntensityPolicy(), paper_spec(), ConstantCarbonSource(N=5), UniformArrivals(M=5), 3)
    net_args = (NetworkAwareDPPPolicy(),) + args[1:]
    for call in (
        lambda: simulate(*args),
        lambda: simulate(*net_args, graph=direct_graph(5, 5)),
        lambda: graph_from_numpy([0], [1.0], [[1.0]], [1], [1.0], [0]),
        lambda: init_links(5, 5),
        lambda: serve_loop(*args),
        lambda: main(["--slots", "2"]),
        lambda: init_state(5, 5),
        lambda: materialize(ConstantCarbonSource(N=5), 2),
        lambda: drift_bound_B(paper_spec(), 400.0),
        lambda: PRNGKey(0),
        lambda: simulate_fleet(CarbonIntensityPolicy(), build_fleet(["diurnal"], per_kind=2), 3),
        lambda: simulate(*args, telemetry=TelemetryConfig()),
        lambda: simulate(*args, telemetry=StreamConfig(flush_every=3)),
        lambda: simulate_fleet(CarbonIntensityPolicy(), build_fleet(["diurnal"], per_kind=2,
                                                                    device="cpu"), 3,
                               telemetry=TelemetryConfig()),
        lambda: simulate_vsweep(lambda V: CarbonIntensityPolicy(V=V), (0.01, 0.1), *args[1:]),
        lambda: build_fleet(["multi-region-uk"], per_kind=1),
        lambda: spec_from_numpy(np.ones(2), np.ones((2, 2)), 1.0, np.ones(2)),
        lambda: build_model(get_smoke_config("glm4_9b")).init(torch.Generator()),
        lambda: build_model(get_smoke_config("mamba2_1_3b")),
        lambda: params_from_reference({"embed": np.zeros((512, 64), np.float32)},
                                      get_smoke_config("glm4_9b")),
        lambda: lm_serve.greedy_generate(Model(get_smoke_config("glm4_9b"), torch.device("cuda")),
                                         {}, torch.zeros((1, 2), dtype=torch.int32), 1, 4),
        lambda: lm_serve.main(["--arch", "glm4_9b", "--smoke"]),
        lambda: init_taps(),
        lambda: init_taps((2,)),
        lambda: simulate(ExactDPPPolicy(), *args[1:]),
        lambda: simulate(ThresholdPolicy(), *args[1:]),
        lambda: bounded_knapsack_min([-1.0], [1.0], [2.0], 4.0, 4),
        lambda: bounded_knapsack_min_batch([[-1.0]], [[1.0]], [[2.0]], [4.0], 4),
        lambda: analysis.iter_combos(),
        lambda: analysis.audit_all(),
        lambda: analysis.sanitize_smoke(),
        lambda: analysis.sanitized_simulate_fleet(
            CarbonIntensityPolicy(), build_fleet(["diurnal"], per_kind=2, device="cpu"), 3),
        lambda: analysis_cli.main(["--audit"]),
        lambda: analysis_cli.main(["--sanitize-smoke"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_kernel_wrappers_take_their_plain_version_only_on_the_cpu():
    from repro_torch.kernels import ops

    Qc = torch.zeros((2, 3))
    c, n1, b = ops.carbon_scores(Qc, torch.ones((2, 3)), torch.zeros(2), torch.ones(2),
                                 torch.ones(3), torch.tensor(1.0))
    assert c.shape == (2, 3) and n1.dtype == torch.int32 and b.shape == (2,)
    for extra in (None, torch.zeros((2, 3))):
        rc, l1, b = ops.route_scores(Qc, torch.ones((2, 3)), Qc, extra, torch.zeros(2),
                                     torch.ones(2), torch.ones(3), torch.tensor(1.0))
        assert rc.shape == (2, 3) and l1.dtype == torch.int32 and b.shape == (2,)
    q, k = torch.zeros((1, 2, 3, 16)), torch.zeros((1, 1, 3, 16))
    assert ops.flash_attention(q, k, k).shape == (1, 2, 3, 16)
    assert ops.flash_decode(q[:, :, 0], k.transpose(1, 2), k.transpose(1, 2), 1).shape == (1, 2, 16)
    y, S_c, total = ops.ssd_chunk_intra(torch.zeros((1, 1, 4, 2)), torch.zeros((1, 1, 4, 2, 8)),
                                        torch.zeros((1, 1, 4, 3)), torch.zeros((1, 1, 4, 3)))
    assert y.shape == (1, 1, 4, 2, 8) and S_c.shape == (1, 1, 2, 3, 8) and total.shape == (1, 1, 2)
    keys = torch.tensor([[0, 1], [0, 2]])
    assert ops.threefry_draw(keys, 3, 4, finish="randint", minval=0, maxval=9).shape == (2, 4)
    from repro_torch.kernels.taps import TapOut
    from repro_torch.telemetry import TelemetryConfig, TelemetryProbe

    z = torch.zeros((2, 5))
    probe = TelemetryProbe(*(torch.zeros((2, 5, 3)) if n == "dispatched" else
                             torch.zeros((2, 5), dtype=torch.int32) if n == "stale" else z
                             for n in TelemetryProbe._fields))
    out, state = TapOut.empty((2,), 5, "cpu"), torch.zeros((2, 7))
    ops.tap_scan(TelemetryConfig(), probe, out, state, 0, 5)
    assert out.alert_active.dtype == torch.int32 and out.records.shape == (2, 3, 6)
    from repro_torch.kernels.taps import ProbePlan

    inputs = {"dispatched": torch.ones((2, 4, 3)), "part0": torch.ones((2, 4))}
    plan = ProbePlan((2,), 5, inputs, {"dispatched": probe.dispatched}, ("part0",),
                     probe.backlog, by_column=("dispatched",))
    ops.tap_probe(plan, 1, inputs)
    assert probe.dispatched[:, 1].eq(4.0).all() and probe.backlog[:, 1].eq(4.0).all()
    counts = ops.knapsack_dp(-torch.ones((2, 3)), torch.ones((2, 3)), torch.full((2, 3), 9.0),
                             torch.full((2,), 4.0), 4)
    assert counts.shape == (2, 3) and counts.sum(-1).eq(4.0).all()
    assert ops.launch_counts() == {"carbon_scores": 0, "route_scores": 0, "greedy_fill": 0,
                                   "flash_attention": 0, "flash_attention_bwd": 0,
                                   "flash_decode": 0, "ssd_chunk_intra": 0,
                                   "ssd_chunk_intra_bwd": 0,
                                   "threefry_draw": 0, "tap_scan": 0, "tap_probe": 0,
                                   "knapsack_dp": 0}
    with pytest.raises(ValueError, match="no kernel"):
        ops.carbon_scores(Qc.to("meta"), Qc, Qc[:, 0], Qc[:, 0], Qc[0], torch.tensor(1.0))
    with pytest.raises(ValueError, match="no kernel"):
        ops.route_scores(Qc.to("meta"), Qc, Qc, None, Qc[:, 0], Qc[:, 0], Qc[0], torch.tensor(1.0))
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_decode(q[:, :, 0].to("meta"), k.to("meta"), k.to("meta"), 1)
    with pytest.raises(ValueError, match="no kernel"):
        ops.threefry_draw(keys.to("meta"), 3, 4)
    with pytest.raises(ValueError, match="no kernel"):
        ops.tap_scan(TelemetryConfig(), probe._replace(backlog=z.to("meta")), out, state, 0, 5)
    with pytest.raises(ValueError, match="no kernel"):
        ops.knapsack_dp(Qc.to("meta"), Qc, Qc, Qc[:, 0], 4)
    plan.backlog = z.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.tap_probe(plan, 1, inputs)


def test_cuda_wrappers_check_their_inputs_before_building():
    """The kernel wrappers refuse what the kernels do not take (dtype,
    head dim, group size, pos on the host) before any build or launch,
    so a bad call cannot fall through to a plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    q, k = torch.zeros((1, 2, 3, 16), dtype=torch.float16), torch.zeros((1, 1, 3, 16))
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="hd"):
        fa.flash_attention_cuda(torch.zeros((1, 2, 3, 24)), torch.zeros((1, 1, 3, 24)),
                                torch.zeros((1, 1, 3, 24)))
    # bf16 goes through TMA: a base off 16 bytes, or an s stride of 34 bytes
    bf = torch.bfloat16
    qb, kb = torch.zeros((1, 2, 3, 16), dtype=bf), torch.zeros((1, 1, 3, 16), dtype=bf)
    shifted = torch.zeros(3 * 16 + 1, dtype=bf)[1:].view(1, 1, 3, 16)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_cuda(qb, shifted, kb)
    wide = torch.zeros((1, 1, 3, 17), dtype=bf)[..., :16]
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_cuda(qb, kb, wide)
    kc = torch.zeros((1, 3, 1, 16))
    with pytest.raises(ValueError, match="pos"):
        fd.flash_decode_cuda(torch.zeros((1, 2, 16)), kc, kc, 1)
    with pytest.raises(ValueError, match="H/K"):
        fd.flash_decode_cuda(torch.zeros((1, 64, 16)), kc, kc, torch.zeros(1, dtype=torch.int32))
    assert fa.launches == 0 and fd.launches == 0


# PyTorch's fused attention, the compiler, and packages of finished kernels
LIBRARY_CALLS = ("scaled_dot_product_attention", "torch.compile", "flash_attn", "xformers",
                 "flashinfer", "transformer_engine", "apex", "liger_kernel")


def test_port_calls_no_library_attention():
    """The port computes attention with its own kernels only: no module
    under src/repro_torch/ names a library attention call, torch.compile
    or a finished-kernel package (chip_smoke.py times SDPA as a yardstick
    and is not part of the package)."""
    found = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*")):
        if path.suffix not in (".py", ".cu", ".cuh", ".h"):
            continue
        text = path.read_text()
        found += [f"{path.relative_to(ROOT)}: {name}" for name in LIBRARY_CALLS if name in text]
        if path.suffix == ".py":
            for mod in _imported_modules(path):
                if mod.split(".")[0] in LIBRARY_CALLS:
                    found.append(f"{path.relative_to(ROOT)} imports {mod}")
    assert not found, found
