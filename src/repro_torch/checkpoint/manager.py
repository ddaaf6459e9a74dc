"""Checkpointing: atomic, resumable, async-capable (counterpart of
`repro.checkpoint.manager`), in the JAX package's on-disk layout.

Layout: <dir>/step_<N>/{arrays.npz, meta.json}. A save writes a tmp dir,
then `os.replace`s it (atomic on POSIX), so a crash mid-save never
corrupts the latest checkpoint; `keep_n` newest steps are kept. Arrays are
named by their `tree_flatten_with_path` paths ("['params']/['embed']",
".m" for a NamedTuple field: `pytree.flatten_with_path`); bf16 arrays are
stored as a uint16 view with the true dtype in meta.json's `_dtypes`, as
JAX stores ml_dtypes arrays. So a directory either package wrote
restores in the other. `save(..., blocking=False)` copies the tensors to
the host now and hands the file write to one background thread; the next
save or `wait()` joins it and raises what it raised.

`restore(like=)` returns a tree of `like`'s structure, each array checked
against its leaf's shape and given its dtype and device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.pytree import flatten_with_path, tree_unflatten

# torch dtypes numpy cannot hold, stored as unsigned views: (view, name in _dtypes)
_VIEWS = {torch.bfloat16: (torch.int16, np.uint16, "bfloat16")}
_BY_NAME = {name: dt for dt, (_, _, name) in _VIEWS.items()}


def _to_host(x) -> Tuple[np.ndarray, Optional[str]]:
    """(numpy array, the true dtype's name if stored as a view)."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype in _VIEWS:
            view, np_view, name = _VIEWS[x.dtype]
            return x.view(view).cpu().numpy().view(np_view), name
        return x.cpu().numpy(), None
    return np.asarray(x), None


def _from_host(arr: np.ndarray, name: Optional[str], ref):
    """A stored array as `ref`'s kind: a tensor of ref's dtype and device
    (a view stored for bf16 read back bit for bit), or numpy."""
    if torch.is_tensor(ref):
        if name is not None:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(_BY_NAME[name])
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=ref.device, dtype=ref.dtype)
    return np.asarray(arr, dtype=np.asarray(ref).dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_n: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, meta: Optional[Dict] = None, blocking: bool = True):
        """Snapshot `tree` at `step`. The device-to-host copy happens now;
        with blocking=False the file write runs on a background thread."""
        self.wait()  # one in-flight save at a time
        dtypes, payload = {}, {}
        for name, leaf in flatten_with_path(tree):
            payload[name], true = _to_host(leaf)
            if true is not None:
                dtypes[name] = true
        meta = dict(meta or {}, step=int(step), _dtypes=dtypes)

        def write():
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **payload)
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=self._guard(write), daemon=True)
            self._thread.start()

    def _guard(self, fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 -- raised again by the next wait()
                self._error = e
        return run

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, int, Dict]:
        """(tree of `like`'s structure, step, meta) from step `step` (the
        latest by default); raises ValueError on a shape mismatch."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "meta.json").read_text())
        dtypes = meta.get("_dtypes", {})
        restored = []
        with np.load(d / "arrays.npz") as z:
            for name, ref in flatten_with_path(like):
                arr = z[name]
                shape = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
                if tuple(arr.shape) != tuple(shape):
                    raise ValueError(f"ckpt shape mismatch at {name}: {arr.shape} vs {shape}")
                restored.append(_from_host(arr, dtypes.get(name), ref))
        return tree_unflatten(like, restored), int(meta["step"]), meta
