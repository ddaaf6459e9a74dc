"""Clairvoyant forecast providers and the forecast-error model
(counterpart of `repro.forecast.source`).

  * ForecastErrorModel     -- multiplicative bias plus heteroscedastic
    noise whose std grows with the lead time and the intensity level;
    lead 0 is exact (the current slot is observed, not forecast).
  * ForecastedCarbonSource -- wraps any carbon source and doubles as a
    forecaster: the true (Ce, Cc) through `__call__`, the corrupted
    future through `predict`.
  * ClairvoyantTableForecaster -- forecasts off a playback table (the
    fleet's twin: `simulate_fleet` hands it each lane's table).

The noise is `normal(fold_in(fold_in(key, seed), t), (H, N+1))`: the key
folded with the seed once a run, then one draw a slot through the draw
kernel (`ops.threefry_draw`, the slot folded in, its `normal` finish:
XLA's erfinv over its log1p, bitwise JAX's).

Rounding follows XLA:CPU inside the simulator's scan. With (bias, noise)
overrides (the fleet's lanes, traced in JAX) the forecast is
fma(truth, 1 + bias, ((noise * truth) * sqrt(h)) * eps); with the
model's own constants XLA folds noise * sqrt(h) first, and with a zero
bias drops the multiply by 1, which leaves fma((noise * sqrt(h)) *
truth, eps, truth); with a nonzero bias fma(truth, 1 + bias, ((noise *
sqrt(h)) * truth) * eps). At bias = noise = 0 every form is `truth`
bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import random as R
from repro_torch.core import rng
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.numerics import fma_f32, sqrt_rn


def _f32(x, device) -> torch.Tensor:
    """x as float32 on `device`; a Python number is written there by
    `torch.full` (no host-to-device copy, no sync inside a slot loop)."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32).to(device)


@dataclasses.dataclass(frozen=True)
class ForecastErrorModel:
    """forecast[h] = truth[h] * (1 + bias) + noise * truth[h] * sqrt(h) * eps.

    bias  -- systematic multiplicative error (+0.1 = 10% over-prediction
             at every lead).
    noise -- heteroscedastic noise fraction: the std at lead h is
             noise * truth * sqrt(h).
    seed  -- the error stream, independent of the world's draws.

    Lead 0 is returned exactly and the result is clipped at 0.
    bias = noise = 0 is the perfect (clairvoyant) forecast.
    """

    bias: float = 0.0
    noise: float = 0.0
    seed: int = 0

    @property
    def exact(self) -> bool:
        return self.bias == 0.0 and self.noise == 0.0

    def stream(self, key) -> torch.Tensor:
        """The key the errors of every slot fold t into, fold_in(key,
        seed) ([..., 2], one a lane); made once a run (the forecasters'
        `init`)."""
        return R.fold_in(key, self.seed)

    def apply(self, truth, t: int, stream, bias=None, noise=None):
        """truth [..., H, N+1] -> the corrupted forecast [..., H, N+1].
        `stream` is `self.stream(key)` (unused, and may be None, for an
        exact model without overrides). `bias` / `noise` override the
        model's parameters (one value, or one a lane): the fleet's
        forecast-quality lanes."""
        truth = truth.float()
        override = bias is not None or noise is not None
        if not override and self.exact:
            return truth
        dev = truth.device
        H, n_cols = truth.shape[-2], truth.shape[-1]
        eps = ops.threefry_draw(stream, t, H * n_cols, finish="normal").reshape(truth.shape)
        h = sqrt_rn(torch.arange(H, dtype=torch.float32, device=dev))[:, None]
        if override:
            b = _f32(self.bias if bias is None else bias, dev)
            n = _f32(self.noise if noise is None else noise, dev)
            b, n = (x[..., None, None] if x.dim() else x for x in (b, n))
            pred = fma_f32(truth, 1.0 + b, ((n * truth) * h) * eps)
        else:
            nh = _f32(self.noise, dev) * h
            if self.bias == 0.0:
                pred = fma_f32(nh * truth, eps, truth)
            else:
                pred = fma_f32(truth, 1.0 + _f32(self.bias, dev), (nh * truth) * eps)
        pred[..., 0, :] = truth[..., 0, :]
        return torch.clamp_min(pred, 0.0)


def _error_carry(error: ForecastErrorModel, key, override, device):
    """(stream, bias, noise) of a clairvoyant forecaster's carry."""
    bias, noise = (None, None) if override is None else override
    if bias is not None:
        bias, noise = _f32(bias, device), _f32(noise, device)
    exact = bias is None and noise is None and error.exact
    return None if exact else error.stream(key), bias, noise


@dataclasses.dataclass(frozen=True)
class ForecastedCarbonSource:
    """A carbon source that also serves its own (possibly corrupted)
    forecast; use it both ways in one run:

        src = ForecastedCarbonSource(UKRegionalTraceSource(N=5), H=16,
                                     error=ForecastErrorModel(noise=0.1))
        simulate(policy, spec, src, arrivals, T, key, forecaster=src)

    The simulator hands its carbon key to `init`, so `predict` reads the
    base source on the same world it serves through `__call__` (H calls
    of the base source a slot)."""

    base: Callable
    H: int = 8
    error: ForecastErrorModel = ForecastErrorModel()

    def to(self, device):
        to = getattr(self.base, "to", None)
        if callable(to):
            to(device)
        return self

    def __call__(self, t: int, key, device):
        return self.base(t, key, device)

    def init(self, N: int, *, key=None, table=None, error=None, device=DEFAULT_DEVICE):
        del N, table
        dev = resolve_device(device)
        key = rng.key_of(0 if key is None else key, dev)
        return (key,) + _error_carry(self.error, key, error, dev)

    def update(self, carry, row):
        del row
        return carry

    def predict(self, carry, t: int):
        key, stream, bias, noise = carry
        rows = []
        for tt in range(t, t + self.H):
            Ce, Cc = self.base(tt, key, key.device)
            rows.append(torch.cat([Ce[..., None], Cc], dim=-1).float())
        return self.error.apply(torch.stack(rows, dim=-2), t, stream, bias, noise)


@dataclasses.dataclass(frozen=True)
class ClairvoyantTableForecaster:
    """Reads the future straight off a playback table (rows repeat
    modulo its length, as TableCarbonSource plays them). The table comes
    through `init(table=...)`: [Tc, N+1], or [F, Tc, N+1] for a fleet,
    so one forecaster serves every lane."""

    H: int = 8
    error: ForecastErrorModel = ForecastErrorModel()

    def init(self, N: int, *, key=None, table=None, error=None, device=DEFAULT_DEVICE):
        del N
        if table is None:
            raise ValueError(
                "ClairvoyantTableForecaster needs a playback table: pass a table-backed "
                "carbon source (TableCarbonSource / fleet lane) or use ForecastedCarbonSource "
                "for functional sources"
            )
        dev = resolve_device(device)
        key = rng.key_of(0 if key is None else key, dev)
        return (_f32(table, dev),) + _error_carry(self.error, key, error, dev)

    def update(self, carry, row):
        del row
        return carry

    def predict(self, carry, t: int):
        table, stream, bias, noise = carry
        Tc = table.shape[-2]
        s = t % Tc
        if s + self.H <= Tc:  # a view: no copy, no index tensor
            truth = table[..., s:s + self.H, :]
        else:
            idx = torch.arange(t, t + self.H, device=table.device) % Tc
            truth = table.index_select(-2, idx)
        return self.error.apply(truth, t, stream, bias, noise)
