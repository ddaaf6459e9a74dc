"""The port's checkpoint manager, and its layout against the JAX package's.

Mirrors tests/test_runtime.py's checkpoint tests (roundtrip with a bf16
leaf, keep_n GC and the latest step, the background write, a shape
mismatch refused), then holds the on-disk layout against
`repro.checkpoint.manager`: a directory the JAX manager wrote (nested
dicts, bf16, int32 and a JAX `AdamWState`) restores in the port bit for
bit, and one the port wrote restores in JAX. Leaf paths are
`tree_flatten_with_path`'s on both sides (`repro_torch.pytree`).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.optim import AdamW, AdamWState  # noqa: E402
from repro_torch.pytree import flatten_with_path, tree_map, tree_unflatten  # noqa: E402


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    mgr = CheckpointManager(tmp_path, keep_n=2)
    mgr.save(3, tree, {"note": "x"})
    restored, step, meta = mgr.restore(tree_map(torch.zeros_like, tree))
    assert step == 3 and meta["note"] == "x"
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor(s)})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, {"x": torch.ones((128, 128))}, blocking=False)
    mgr.wait()
    restored, step, _ = mgr.restore({"x": torch.zeros((128, 128))})
    assert step == 7
    assert float(restored["x"].sum()) == 128 * 128


def test_checkpoint_async_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    mgr.save(1, {"x": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.ones((4,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"x": torch.zeros((5,))})


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore({"x": torch.zeros(1)})


def _jax_tree():
    rng = np.random.default_rng(0)
    params = {
        "layers": {"wq": jnp.asarray(rng.standard_normal((2, 3, 4)), jnp.bfloat16),
                   "ln": {"scale": jnp.asarray(rng.standard_normal(3), jnp.float32)}},
        "embed": jnp.asarray(rng.standard_normal((5, 3)), jnp.float32),
        "count": jnp.asarray(rng.integers(0, 100, 4), jnp.int32),
    }
    opt = JaxAdamW().init(params)
    opt = opt._replace(m=jax.tree.map(lambda x: x + 0.5, opt.m), step=jnp.asarray(9, jnp.int32))
    return {"params": params, "opt": opt}


def _port_like():
    params = {"layers": {"wq": torch.zeros((2, 3, 4), dtype=torch.bfloat16),
                         "ln": {"scale": torch.zeros(3)}},
              "embed": torch.zeros((5, 3)), "count": torch.zeros(4, dtype=torch.int32)}
    return {"params": params, "opt": AdamW().init(params)}


def _bits(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def test_paths_are_jax_tree_paths():
    names = [n for n, _ in flatten_with_path(_port_like())]
    want = ["/".join(str(k) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(_jax_tree())[0]]
    assert names == want


def test_jax_directory_restores_in_the_port(tmp_path):
    tree = _jax_tree()
    JaxManager(tmp_path).save(9, tree, {"t": 9})
    meta = json.loads((tmp_path / "step_9" / "meta.json").read_text())
    assert meta["_dtypes"] == {"['params']/['layers']/['wq']": "bfloat16"}
    got, step, meta = CheckpointManager(tmp_path).restore(_port_like())
    assert step == 9 and meta["t"] == 9
    assert isinstance(got["opt"], AdamWState) and got["opt"].step.dtype == torch.int32
    for (name, g), w in zip(flatten_with_path(got), jax.tree.leaves(tree)):
        gn = g.view(torch.int16).numpy().view(np.uint16) if g.dtype == torch.bfloat16 else g.numpy()
        np.testing.assert_array_equal(gn, _bits(w), err_msg=name)


def test_port_directory_restores_in_jax(tmp_path):
    like = _port_like()
    rng = np.random.default_rng(1)
    leaves = [torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32)).to(x.dtype)
              if x.dtype != torch.int32 else torch.arange(x.numel(), dtype=torch.int32).reshape(x.shape)
              for _, x in flatten_with_path(like)]
    tree = tree_unflatten(like, leaves)
    mgr = CheckpointManager(tmp_path)
    mgr.save(4, tree, {"t": 4}, blocking=False)
    mgr.wait()
    got, step, _ = JaxManager(tmp_path).restore(_jax_tree())
    assert step == 4
    for (name, t), g in zip(flatten_with_path(tree), jax.tree.leaves(got)):
        tn = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(_bits(g), tn, err_msg=name)


def test_training_modules_load_no_jax():
    """The training slice's modules import torch and numpy, never jax."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys, repro_torch.optim, repro_torch.checkpoint, repro_torch.data, "
            "repro_torch.orchestrator, repro_torch.launch.train, repro_torch.pytree; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
