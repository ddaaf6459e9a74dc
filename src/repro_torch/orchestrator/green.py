"""GreenOrchestrator: the paper's carbon-intensity scheduler as the
control plane for real training jobs (counterpart of
`repro.orchestrator.green`).

Mapping (paper -> runtime):
  task type m   -> a TrainJob (architecture + data stream + optimizer)
  cloud n       -> a Cloud execution slot (here: the local device, with
                   per-cloud speed to emulate heterogeneity and stragglers)
  d[m,n]        -> staging a task's data/weights to cloud n (edge energy)
  w[m,n]        -> running `steps_per_task` real train steps of job m
  C(t)          -> measured-FLOPs energy proxy x live carbon intensity

The queues live on `device` (the card unless the caller passes "cpu"),
so on the card each slot's Algorithm 1 runs the `carbon_scores` and
`greedy_fill` kernels (`CarbonIntensityPolicy`); the action comes to the
host, where the clouds run their tasks and the emissions are summed in
numpy float32, as in the JAX package. `TrainJob.run_task` reads the last
step's loss on the host, so the straggler clock times the steps and not
their launch.

Fault tolerance: a checkpoint every `ckpt_every` slots (every job's
params and optimizer state, the virtual queues, the emission accumulator;
atomic, non-blocking), `resume()` from the latest one (bit-exact
afterwards: carbon and arrivals are pure in t, and the train steps are
deterministic), straggler mitigation through each cloud's measured
slowdown, and elasticity through the alive mask (a dead cloud's Pc is 0).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.policies import CarbonIntensityPolicy
from repro_torch.core.queueing import Action, NetworkSpec, NetworkState, init_state
from repro_torch.core.queueing import step as queue_step
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class TrainJob:
    """One task type: a live training run."""

    name: str
    model: object
    train_step: Callable  # (params, opt_state, batch) -> (p', o', metrics)
    batch_fn: Callable    # step -> batch
    params: object
    opt_state: object
    steps_per_task: int = 2
    step: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)

    def run_task(self) -> Dict[str, float]:
        for _ in range(self.steps_per_task):
            batch = self.batch_fn(self.step)
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            self.step += 1
        loss = float(metrics["loss"])  # waits for the steps: the slot clock measures them
        self.losses.append(loss)
        return {"loss": loss, "step": self.step}

    def flops_per_task(self, tokens_per_step: int) -> float:
        return 6.0 * self.model.cfg.active_params() * tokens_per_step * self.steps_per_task


@dataclasses.dataclass
class Cloud:
    name: str
    alive: bool = True
    speed: float = 1.0          # emulated relative throughput
    measured_slowdown: float = 1.0  # EWMA of observed / expected time


class GreenOrchestrator:
    def __init__(
        self,
        jobs: List[TrainJob],
        clouds: List[Cloud],
        spec: NetworkSpec,
        carbon_source: Callable,       # (t, key, device) -> (Ce, Cc)
        arrival_fn: Callable,          # t -> np.ndarray [M]
        policy=None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 5,
        max_tasks_per_slot: int = 4,   # wall-clock cap per (cloud, slot)
        slot_deadline_s: Optional[float] = None,
        carbon_key: Optional[torch.Tensor] = None,
        device=DEFAULT_DEVICE,
    ):
        if len(jobs) != spec.M or len(clouds) != spec.N:
            raise ValueError(f"GreenOrchestrator: {len(jobs)} jobs and {len(clouds)} clouds for "
                             f"a spec of M={spec.M}, N={spec.N}")
        self.device = resolve_device(device)
        self.jobs = jobs
        self.clouds = clouds
        self.spec = spec
        self.carbon = carbon_source
        self.arrivals = arrival_fn
        self.policy = policy or CarbonIntensityPolicy(V=0.05)
        self.state = init_state(spec.M, spec.N, self.device)
        self.t = 0
        self.cum_emissions = 0.0
        self.cum_emissions_trace: List[float] = []
        self.executed_tasks = 0
        self.max_tasks_per_slot = max_tasks_per_slot
        self.slot_deadline_s = slot_deadline_s
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self._carbon_key = carbon_key if carbon_key is not None else jr.PRNGKey(0, self.device)
        self._pe = np.asarray(_host(spec.pe), np.float32)
        self._pc = np.asarray(_host(spec.pc), np.float32)

    # ------------------------------------------------------------ state --
    def _snapshot_tree(self):
        return {
            "queues": {"Qe": self.state.Qe, "Qc": self.state.Qc},
            "jobs": {j.name: {"params": j.params, "opt": j.opt_state} for j in self.jobs},
        }

    def checkpoint(self, blocking: bool = True):
        if not self.ckpt:
            return
        meta = {
            "t": self.t,
            "cum_emissions": self.cum_emissions,
            "executed_tasks": self.executed_tasks,
            "job_steps": {j.name: j.step for j in self.jobs},
            "cloud_alive": [c.alive for c in self.clouds],
        }
        self.ckpt.save(self.t, self._snapshot_tree(), meta, blocking=blocking)

    def resume(self) -> bool:
        if not self.ckpt or self.ckpt.latest_step() is None:
            return False
        tree, _, meta = self.ckpt.restore(self._snapshot_tree())
        self.state = NetworkState(Qe=tree["queues"]["Qe"], Qc=tree["queues"]["Qc"])
        for j in self.jobs:
            j.params = tree["jobs"][j.name]["params"]
            j.opt_state = tree["jobs"][j.name]["opt"]
            j.step = int(meta["job_steps"][j.name])
        for c, alive in zip(self.clouds, meta["cloud_alive"]):
            c.alive = bool(alive)
        self.t = int(meta["t"])
        self.cum_emissions = float(meta["cum_emissions"])
        self.executed_tasks = int(meta["executed_tasks"])
        return True

    # -------------------------------------------------------- elasticity --
    def fail_cloud(self, n: int):
        self.clouds[n].alive = False

    def join_cloud(self, n: int):
        self.clouds[n].alive = True
        self.clouds[n].measured_slowdown = 1.0

    def _effective_spec(self) -> NetworkSpec:
        """Straggler/elastic-aware capacities: dead -> 0, slow -> shrunk."""
        Pc = np.asarray(_host(self.spec.Pc), np.float32).copy()
        for n, c in enumerate(self.clouds):
            if not c.alive:
                Pc[n] = 0.0
            elif c.measured_slowdown > 1.05:
                Pc[n] = Pc[n] / c.measured_slowdown
        return dataclasses.replace(self.spec, Pc=Pc)

    @staticmethod
    def _slowdown(elapsed: float, deadline: float, expected: float) -> float:
        """Observed/expected slot time ratio for the straggler EWMA: a
        cloud that ran `expected` task-equivalents is on schedule when
        elapsed ~= deadline * expected (the denominator clamped below at
        one task)."""
        return elapsed / (deadline * max(expected, 1.0))

    # -------------------------------------------------------------- run --
    def run_slot(self) -> Dict[str, float]:
        t, dev = self.t, self.device
        Ce, Cc = self.carbon(t, self._carbon_key, dev)
        a = self.arrivals(t)
        a_dev = torch.as_tensor(np.asarray(a, np.float32), device=dev)
        act = self.policy(self.state, self._effective_spec().to(dev), Ce, Cc, a_dev, None)
        d = act.d.cpu().numpy()
        w = act.w.cpu().numpy().copy()

        # execute processing: real train steps, capped per slot
        slot_metrics = {}
        for n, cloud in enumerate(self.clouds):
            if not cloud.alive:
                w[:, n] = 0
                continue
            budget = self.max_tasks_per_slot
            t_start = time.monotonic()
            expected = 0.0
            for m in range(self.spec.M):
                todo = int(min(w[m, n], budget))
                done = 0
                for _ in range(todo):
                    if (self.slot_deadline_s is not None
                            and time.monotonic() - t_start > self.slot_deadline_s):
                        break
                    metrics = self.jobs[m].run_task()
                    expected += 1.0
                    done += 1
                    self.executed_tasks += 1
                    slot_metrics[f"loss/{self.jobs[m].name}"] = metrics["loss"]
                budget -= done
                w[m, n] = done  # only what actually ran leaves the queue
            elapsed = time.monotonic() - t_start
            if self.slot_deadline_s is not None and expected > 0:
                # emulated heterogeneity: a declared-slow cloud observes
                # inflated wall time (tasks run at real local speed)
                slowdown = self._slowdown(elapsed / max(cloud.speed, 1e-3),
                                          self.slot_deadline_s, expected)
                cloud.measured_slowdown = (
                    0.7 * cloud.measured_slowdown + 0.3 * max(slowdown, 1.0))

        # emissions accounting, eq. (5), with the *executed* action
        Cc_host = Cc.cpu().numpy()
        edge_e = float((d * self._pe[:, None]).sum())
        cloud_e = (w * self._pc).sum(axis=0)
        C_t = float(Ce) * edge_e + float(np.dot(Cc_host, cloud_e))
        self.cum_emissions += C_t
        self.cum_emissions_trace.append(self.cum_emissions)

        self.state = queue_step(
            self.state,
            Action(d=torch.as_tensor(d, device=dev), w=torch.as_tensor(w, device=dev)),
            a_dev)
        self.t += 1
        if self.ckpt and self.t % self.ckpt_every == 0:
            self.checkpoint(blocking=False)
        return dict(
            slot_metrics,
            emissions=C_t,
            backlog=float(self.state.Qe.sum() + self.state.Qc.sum()),
            executed=self.executed_tasks,
        )

    def run(self, n_slots: int, fail_at: Optional[Dict[int, int]] = None):
        """fail_at: {slot: cloud} simulated cloud failures."""
        history = []
        fail_at = fail_at or {}
        for _ in range(n_slots):
            if self.t in fail_at:
                self.fail_cloud(fail_at[self.t])
            history.append(self.run_slot())
        if self.ckpt:
            self.ckpt.wait()
        return history


def _host(x):
    """A spec field (numpy, float or tensor) as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
