"""Static and dynamic checks of the port (counterpart of
`repro.analysis`): the JAX package's checks translated to eager
PyTorch, and no check that JAX lacks.

  * ``analysis.audit``    -- runs every registered (policy x scenario)
    combination through the port's loops and checks dtype discipline
    (float32 / int32 / uint32 / bool in every carried and recorded
    field, the same under a float64 default dtype) and that no slot
    syncs with the host.
  * ``analysis.sanitize`` -- runs the simulators under a dispatch mode
    that raises on a NaN from NaN-free inputs, an integer division by
    zero or an out-of-range index; a CI smoke battery.
  * ``analysis.lint``     -- stdlib-``ast`` lint with the port's rules
    (host reads in the hot path, Python ``for`` over tensors, ctypes
    loads outside `kernels/build.py`, mutable default args, unused
    imports).

CLI: ``python -m repro_torch.analysis [--lint] [--audit]
[--sanitize-smoke] [--device DEV]`` exits nonzero on any finding not
recorded in ``baseline.json``.
"""
from repro_torch.analysis.audit import AuditViolation, audit_all, audit_combo, iter_combos
from repro_torch.analysis.lint import LintViolation, lint_paths, lint_repo
from repro_torch.analysis.sanitize import (
    SanitizeError,
    sanitize_smoke,
    sanitized_simulate_fleet,
)

__all__ = [
    "AuditViolation",
    "audit_all",
    "audit_combo",
    "iter_combos",
    "LintViolation",
    "lint_paths",
    "lint_repo",
    "SanitizeError",
    "sanitize_smoke",
    "sanitized_simulate_fleet",
]
