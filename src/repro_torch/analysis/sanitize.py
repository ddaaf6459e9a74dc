"""Sanitizer harness for the simulators (counterpart of
`repro.analysis.sanitize`, which lifts them through checkify).

A TorchDispatchMode watches every op of a run and raises `SanitizeError`
at the first of checkify's `float_checks | index_checks`:

  * a NaN produced by an op whose inputs hold none;
  * an integer division (or remainder) by zero;
  * an index out of range in an index, gather, scatter, index_select,
    index_add or embedding op.

`sanitized_simulate_fleet` runs a whole fleet under it; `sanitize_smoke`
is the CI battery (JAX's cases: one a simulator entry point, the
chunked fill, the WAN, fault and deadline layers), run by
`python -m repro_torch.analysis --sanitize-smoke`. JAX runs its fleets
with NaN and division checks only (checkify cannot instrument a batched
scatter); here every case runs every check. The checks cost a few
reductions an op, so the battery runs at smoke size.
"""
from __future__ import annotations

import traceback
from typing import Callable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import DEFAULT_DEVICE, resolve_device

SMOKE_T = 24
SMOKE_M, SMOKE_N = 4, 3
SMOKE_PER_KIND = 2

# op name -> (position of the indexed tensor, of the dim or None, of the index)
_DIM_INDEXED = {
    "aten::gather": (0, 1, 2),
    "aten::scatter": (0, 1, 2),
    "aten::scatter_": (0, 1, 2),
    "aten::scatter_add": (0, 1, 2),
    "aten::scatter_add_": (0, 1, 2),
    "aten::scatter_reduce": (0, 1, 2),
    "aten::scatter_reduce_": (0, 1, 2),
    "aten::index_select": (0, 1, 2),
    "aten::index_add": (0, 1, 2),
    "aten::index_add_": (0, 1, 2),
    "aten::index_copy": (0, 1, 2),
    "aten::index_copy_": (0, 1, 2),
    "aten::index_fill": (0, 1, 2),
    "aten::index_fill_": (0, 1, 2),
    "aten::embedding": (0, None, 1),
}
_INDEX_LISTS = ("aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_")
_INT_DIVISIONS = ("aten::div", "aten::div_", "aten::floor_divide", "aten::floor_divide_",
                  "aten::remainder", "aten::remainder_", "aten::fmod", "aten::fmod_")


class SanitizeError(RuntimeError):
    """A check failed: the op, what it found, and where in the port."""


def _where() -> str:
    for fr in reversed(traceback.extract_stack()):
        if "repro_torch" in fr.filename and "analysis" not in fr.filename:
            return f"{fr.filename.split('src/')[-1]}:{fr.lineno} ({fr.name})"
    return "?"


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _has_nan(x) -> bool:
    return any(t.is_floating_point() and t.numel() and bool(torch.isnan(t).any())
               for t in _tensors(x))


def _out_of_range(idx: torch.Tensor, n: int, negative: bool) -> bool:
    if idx.numel() == 0:
        return False
    lo = -n if negative else 0
    return bool((idx < lo).any() or (idx >= n).any())


# ops that make a tensor from no tensor: a NaN there is a constant (or, for
# the empty ones, memory not written yet), not a NaN an operation produced
_CONSTANTS = ("aten::scalar_tensor", "aten::full", "aten::full_like", "aten::fill",
              "aten::fill_", "aten::new_full", "aten::empty", "aten::empty_like",
              "aten::empty_strided", "aten::new_empty", "aten::new_empty_strided",
              "aten::lift_fresh", "aten::lift_fresh_copy")


class Sanitizer(TorchDispatchMode):
    """Raises SanitizeError at the first NaN from NaN-free inputs, integer
    division by zero or out-of-range index (see the module docstring).

    The float32 emulations of `kernels.numerics` marked `one_op` (fma_f32,
    XLA's log1p, exp, erfinv, ...) each stand for one operation of XLA's:
    the sanitizer checks their inputs and output, not the ops inside
    them (TwoSum's inf - inf on an infinite sum, the NaN constants of
    log's specials)."""

    def __init__(self):
        super().__init__()
        self.inside = 0  # depth of one_op emulations being run

    def _one_op(self, fn, args, kwargs):
        nan_in = _has_nan(args) or _has_nan(kwargs) or any(
            isinstance(x, float) and x != x for x in args)
        self.inside += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.inside -= 1
        if not self.inside and not nan_in and _has_nan(out):
            raise SanitizeError(f"NaN produced by {fn.__name__} from NaN-free inputs at "
                                f"{_where()}")
        return out

    def __enter__(self):
        from repro_torch.kernels import numerics

        self._hook = numerics.OP_HOOK
        numerics.OP_HOOK = self._one_op
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import numerics

        numerics.OP_HOOK = self._hook
        return super().__exit__(*exc)

    def _check_index(self, name, args):
        if name in _DIM_INDEXED:
            src, dim, at = _DIM_INDEXED[name]
            x, idx = args[src], args[at]
            if not torch.is_tensor(idx):
                return
            n = x.shape[0] if dim is None else (x.shape[args[dim]] if x.dim() else 1)
            if _out_of_range(idx, n, negative=False):
                raise SanitizeError(f"index out of range [0, {n}) in {name} at {_where()}")
        elif name in _INDEX_LISTS:
            x, d = args[0], 0
            for idx in args[1]:
                if idx is None:
                    d += 1
                    continue
                if idx.dtype == torch.bool:
                    d += idx.dim()
                    continue
                n = x.shape[d]
                if _out_of_range(idx, n, negative=True):
                    raise SanitizeError(f"index out of range [-{n}, {n}) in {name} at {_where()}")
                d += 1

    def _check_division(self, name, args):
        if name not in _INT_DIVISIONS or len(args) < 2:
            return
        num, den = args[0], args[1]
        ints = [not t.is_floating_point() and not t.is_complex() for t in (num, den)
                if torch.is_tensor(t)]
        if not ints or not all(ints) or (not torch.is_tensor(den) and isinstance(den, float)):
            return
        zero = bool((den == 0).any()) if torch.is_tensor(den) else den == 0
        if zero:
            raise SanitizeError(f"integer division by zero in {name} at {_where()}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name  # the op without its overload
        if self.inside or not name.startswith("aten::"):
            return func(*args, **kwargs)
        self._check_index(name, args)
        self._check_division(name, args)
        nan_in = _has_nan(args) or _has_nan(kwargs)
        out = func(*args, **kwargs)
        if not nan_in and name not in _CONSTANTS and _has_nan(out):
            raise SanitizeError(f"NaN produced by {name} from NaN-free inputs at {_where()}")
        return out


def sanitized(fn: Callable, *args, **kwargs):
    """Runs fn(*args, **kwargs) under the sanitizer -> (message or None,
    result or None)."""
    try:
        with Sanitizer():
            return None, fn(*args, **kwargs)
    except SanitizeError as e:
        return str(e), None


def sanitized_simulate_fleet(policy: Callable, fleet, T: int, key=0, forecaster=None,
                             record="summary", device=DEFAULT_DEVICE):
    """`simulate_fleet` under the sanitizer -> (message or None, result
    or None): None on a clean run."""
    from repro_torch.core.simulator import simulate_fleet

    return sanitized(simulate_fleet, policy, fleet, T, key, record=record,
                     device=resolve_device(device), forecaster=forecaster)


def sanitize_smoke(T: int = SMOKE_T, device=DEFAULT_DEVICE) -> List[Tuple[str, str | None]]:
    """One sanitized run per simulator entry point at smoke size, JAX's
    cases -> [(case name, message or None)]; all None = clean.

      * `simulate_fleet` on the diurnal-slack fleet under the default
        policy, and under LookaheadDPPPolicy with a seasonal-naive
        forecaster;
      * the WAN path: NetworkAwareDPPPolicy on congested-uplink;
      * the clairvoyant forecaster with the error model on the lanes;
      * the fault layer: the blackout fleet under the staleness guard,
        the flappy-uplink WAN fleet under the guarded WAN policy;
      * single-instance `simulate` at the paper spec, and with
        fill_chunk=2 (the JAX package's chunked fill; here the same
        kernel);
      * a single faulted run (brownouts, dropouts, failures) and a
        single deadline run with shedding (slack through +inf).
    """
    import numpy as np

    from repro_torch.configs.fleet_scenarios import (
        build_fleet,
        build_network_fleet,
        with_faults,
    )
    from repro_torch.configs.paper_workloads import paper_spec
    from repro_torch.core.carbon import RandomCarbonSource
    from repro_torch.core.policies import CarbonIntensityPolicy, LookaheadDPPPolicy
    from repro_torch.core.simulator import UniformArrivals, simulate, sweep_forecast_errors
    from repro_torch.deadlines import SlackThresholdPolicy, make_deadlines
    from repro_torch.faults import StalenessGuardPolicy, make_faults
    from repro_torch.forecast import ClairvoyantTableForecaster, SeasonalNaiveForecaster
    from repro_torch.network import NetworkAwareDPPPolicy

    dev = resolve_device(device)
    size = dict(per_kind=SMOKE_PER_KIND, M=SMOKE_M, N=SMOKE_N, Tc=24, seed=0, device=dev)
    fleet = build_fleet(["diurnal-slack"], **size)
    wan = build_network_fleet(["congested-uplink"], **size)

    def on_fleet(policy, fl, forecaster=None):
        return lambda: sanitized_simulate_fleet(policy, fl, T, 0, forecaster=forecaster,
                                                device=dev)

    spec = paper_spec()

    def single(policy, **kw):
        return lambda: sanitized(simulate, policy, spec, RandomCarbonSource(N=spec.N),
                                 UniformArrivals(M=spec.M), T, 0, device=dev, **kw)

    faults = make_faults(spec.N, device=dev, cloud_p_down=0.05, cloud_p_up=0.3,
                         brown_p_start=0.1, brown_p_end=0.2, brown_floor=0.5,
                         telem_p_down=0.2, telem_p_up=0.2, task_p_fail=0.1)
    deadlines = make_deadlines(
        spec.M, device=dev,
        deadline=np.array([1.0, 3.0, np.inf, 2.0, np.inf], np.float32)[: spec.M],
        window=2.0, shed_on=1.0, headroom=0.8)
    cases = [
        ("fleet/diurnal-slack/ci", on_fleet(CarbonIntensityPolicy(), fleet)),
        ("fleet/diurnal-slack/lookahead-seasonal",
         on_fleet(LookaheadDPPPolicy(H=4), fleet, SeasonalNaiveForecaster(H=4, period=6))),
        ("fleet/congested-uplink/aware", on_fleet(NetworkAwareDPPPolicy(), wan)),
        ("fleet/diurnal-slack/clairvoyant-err",
         on_fleet(LookaheadDPPPolicy(H=4), sweep_forecast_errors(fleet, bias=0.05, noise=0.1),
                  ClairvoyantTableForecaster(H=4))),
        ("fleet/diurnal-slack+blackout/guard-ci",
         on_fleet(StalenessGuardPolicy(inner=CarbonIntensityPolicy()),
                  with_faults(fleet, "regional-blackout"))),
        ("fleet/congested-uplink+flappy/guard-aware",
         on_fleet(StalenessGuardPolicy(inner=NetworkAwareDPPPolicy()),
                  with_faults(wan, "flappy-uplink"))),
        ("single/paper-spec/ci", single(CarbonIntensityPolicy())),
        ("single/paper-spec/chunked-fill", single(CarbonIntensityPolicy(fill_chunk=2))),
        ("single/paper-spec+faults/guard-ci",
         single(StalenessGuardPolicy(inner=CarbonIntensityPolicy()), faults=faults)),
        ("single/paper-spec+deadlines/slack-shed",
         single(SlackThresholdPolicy(), deadlines=deadlines)),
    ]
    results: List[Tuple[str, str | None]] = []
    for name, run in cases:
        try:
            msg, _ = run()
        except Exception as e:  # the run itself failed
            msg = f"the run failed: {e!r}"
        results.append((name, msg))
    return results
