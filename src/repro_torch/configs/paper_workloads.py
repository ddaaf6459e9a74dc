"""Paper §V experimental setup (Table I + network constants).

A copy of `repro.configs.paper_workloads` (the port imports nothing of
the JAX package): M=5 AI-training task types on ImageNet, N=5
homogeneous clouds, energy in kWh. `lm_workloads` comes with the LM
stack in a later slice.
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
