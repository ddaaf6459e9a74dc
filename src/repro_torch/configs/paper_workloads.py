"""Paper §V experimental setup (Table I + network constants).

A copy of `repro.configs.paper_workloads` (the port imports nothing of
the JAX package): M=5 AI-training task types on ImageNet, N=5
homogeneous clouds, energy in kWh. `lm_workloads` extends the task-type
set with the LM architectures, each costed from its per-step FLOPs
(6 * N_active * tokens) at an energy per FLOP that the caller states: the
accelerator's peak FLOP/s, its power in kW and the MFU reached are
arguments with no default (the JAX package fixes them for a TPU v5e; on
an H100 chip_smoke.py phase 13 passes the card's peak and power limit and
the MFU it measured).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.queueing import NetworkSpec

# Table I: (model, pc kWh (all clouds), pe kWh)
TABLE_I = (
    ("ResNet50", 74.0, 3.45),
    ("InceptionV3", 97.0, 3.45),
    ("DenseNet121", 54.0, 3.45),
    ("SqueezeNet", 16.0, 3.45),
    ("MobileNetV2", 5.8, 3.45),
)

P_EDGE = 4000.0          # kWh per slot
P_CLOUD = 30000.0        # kWh per slot, each of N=5 clouds
N_CLOUDS = 5
A_MAX = 400              # a_m(t) ~ U{0..400}
V_PAPER = 0.05
C_MAX_RANDOM = 700       # random carbon intensity ~ U{0..700}


def paper_spec() -> NetworkSpec:
    """The paper's network as numpy fields; `simulate` moves it to its
    device (`NetworkSpec.to`)."""
    pe = np.array([row[2] for row in TABLE_I], np.float32)
    pc = np.tile(np.array([row[1] for row in TABLE_I], np.float32)[:, None], (1, N_CLOUDS))
    return NetworkSpec(pe=pe, pc=pc, Pe=P_EDGE, Pc=np.full((N_CLOUDS,), P_CLOUD, np.float32))


# ---------------------------------------------------------------------------
# Bridge: LM architectures as task types. Energy per "task" = a training
# bundle of `steps_per_task` steps:
#   FLOPs = 6 * N_active_params * tokens_per_step * steps_per_task
#   energy_kWh = FLOPs / (mfu * peak_flops) seconds * chip_kw / 3600
# What matters to the scheduler is only the relative pc and the budgets'
# scale.

def lm_task_energy_kwh(n_active_params: float, tokens_per_step: float,
                       steps_per_task: int = 100, *, peak_flops: float, chip_kw: float,
                       mfu: float) -> float:
    """kWh of one task: steps_per_task steps of tokens_per_step tokens on
    one accelerator of `peak_flops` FLOP/s drawing `chip_kw` kW at `mfu`."""
    flops = 6.0 * n_active_params * tokens_per_step * steps_per_task
    seconds = flops / (mfu * peak_flops)
    return seconds / 3600.0 * chip_kw


def lm_workloads(arch_ids=None, n_clouds: int = N_CLOUDS, *, peak_flops: float, chip_kw: float,
                 mfu: float) -> NetworkSpec:
    """NetworkSpec whose task types are the LM architectures (numpy
    fields), each task one train_4k micro-bundle of 4096 x 8 tokens a
    step; the budgets scaled so the mean load is about 0.35, as in the
    paper's setup. arch_ids defaults to every architecture the port has a
    config for (the JAX package's default also holds the hybrid Jamba,
    whose config is not ported: `registry.NOT_PORTED`)."""
    from repro_torch.configs import registry

    arch_ids = arch_ids or [a for a in registry.ARCH_IDS if a not in registry.NOT_PORTED]
    pcs, pes = [], []
    for aid in arch_ids:
        cfg = registry.get_config(aid)
        tokens = 4096 * 8  # one micro-bundle of train_4k tokens
        pcs.append(lm_task_energy_kwh(cfg.active_params(), tokens, peak_flops=peak_flops,
                                      chip_kw=chip_kw, mfu=mfu))
        # edge send cost ~ checkpoint-shard + data shard transfer at
        # 0.023 kWh/GB (paper's Malmodin-Lunden figure), 5% of the weights
        gb = cfg.active_params() * 2 / 1e9 * 0.05
        pes.append(max(gb * 0.023, 1e-3))
    pe = np.asarray(pes, np.float32)
    pc = np.tile(np.asarray(pcs, np.float32)[:, None], (1, n_clouds))
    mean_demand = float(np.mean(pc)) * (A_MAX / 2) * len(arch_ids)
    return NetworkSpec(
        pe=pe,
        pc=pc,
        Pe=float(np.mean(pe) * (A_MAX / 2) * len(arch_ids) / 0.85),
        Pc=np.full((n_clouds,), mean_demand / n_clouds / 0.35, np.float32),
    )
