"""Carbon-intensity forecasters (counterpart of `repro.forecast.forecasters`).

A forecaster turns the stream of observed intensity rows into an
[H, N+1] forecast each slot (column 0 = edge region, columns 1..N =
clouds, the playback-table layout of `core/carbon.py`). The contract:

    H : int                                    -- horizon (slots)
    init(N, *, key=None, table=None, error=None, device=...) -> carry
        `error` is an optional (bias, noise) override pair for the
        clairvoyant forecasters' ForecastErrorModel (the fleet's
        forecast-quality lanes); statistical forecasters ignore it.
    update(carry, row [..., N+1]) -> carry     -- observe slot t's row
    predict(carry, t) -> [..., H, N+1] float32 -- row 0 = slot t (the
        last observed row), rows h >= 1 predict t + h

`update` runs before `predict` each slot, so row 0 is the intensity the
policy already observes, which makes `LookaheadDPPPolicy(H=1)` act as
the myopic policy. Rows may carry a leading lane axis (a fleet): the
carry starts without lanes and takes those of the first row it sees.
The slot count lives in the carry as a Python int (every lane observes
the same number of slots), so the loop reads no device value.

  * PersistenceForecaster   -- the last observation, flat ahead.
  * SeasonalNaiveForecaster -- the value one period ago.
  * EWMAForecaster          -- an exponentially weighted level, flat
    ahead; the update is fma(alpha, row, (1 - alpha) * level), single
    rounded, as XLA:CPU contracts it inside the simulator's scan.
  * RidgeARForecaster       -- per-region AR(p) with intercept, a ridge
    least-squares refit every slot, rolled forward H-1 steps. The Gram
    products, the elimination and the roll are elementwise torch calls
    in one fixed order (`solve_gauss`), so a lane of a fleet gives its
    single run's forecast bitwise, on any device. The JAX solve is
    LAPACK's, so this one agrees with it to rounding, not bitwise.

The clairvoyant forecasters live in `forecast/source.py`, the accuracy
metrics in `forecast/metrics.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.numerics import fma_f32


@runtime_checkable
class Forecaster(Protocol):
    """Structural type of what `simulate(..., forecaster=)` accepts."""

    H: int

    def init(self, N: int, *, key=None, table=None, error=None, device=DEFAULT_DEVICE) -> Any:
        ...

    def update(self, carry: Any, row: torch.Tensor) -> Any:
        ...

    def predict(self, carry: Any, t: int) -> torch.Tensor:
        ...


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=resolve_device(device))


def _sum_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """sum over `dim` as a chain of elementwise adds in index order: the
    same bits whatever the other axes hold (a batched reduction or
    matrix product may block its sums by the batch's shape)."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _fma_rows(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """sum over `dim` of a*b (broadcast) as one single-rounded FMA a row
    in index order, from +0."""
    acc = torch.zeros_like(a.select(dim, 0) * b.select(dim, 0))
    for i in range(a.shape[dim]):
        acc = fma_f32(a.select(dim, i), b.select(dim, i), acc)
    return acc


def solve_gauss(aug: torch.Tensor) -> torch.Tensor:
    """x of A x = b for the augmented [A | b], [..., n, n+1]: Gaussian elimination
    with partial pivoting (the first row of largest |pivot|) and back
    substitution, each multiply-subtract one FMA (`fma_f32`), as a
    compiled LAPACK forms them; every step is an elementwise torch call
    over the batch, so each system's bits do not depend on the batch it
    is solved in."""
    n = aug.shape[-2]
    rows = torch.arange(n, device=aug.device)
    for k in range(n):
        piv = k + torch.argmax(aug[..., k:, k].abs(), dim=-1)        # [...]
        perm = torch.where(rows == k, piv[..., None],
                           torch.where(rows == piv[..., None], k, rows))
        aug = aug.gather(-2, perm[..., None].expand(aug.shape))
        top = aug[..., k:k + 1, :]                                   # [..., 1, n+1]
        f = aug[..., k + 1:, k:k + 1] / top[..., k:k + 1]            # [..., n-k-1, 1]
        aug = torch.cat([aug[..., :k + 1, :], fma_f32(-f, top, aug[..., k + 1:, :])], dim=-2)
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = aug[..., i, n]
        for j in range(i + 1, n):
            acc = fma_f32(-aug[..., i, j], x[j], acc)
        x[i] = acc / aug[..., i, i]
    return torch.stack(x, dim=-1)


def _tile_last(row: torch.Tensor, H: int) -> torch.Tensor:
    """[..., N+1] -> [..., H, N+1] persistence forecast."""
    return row[..., None, :].expand(row.shape[:-1] + (H, row.shape[-1]))


def _push(buf: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """roll(buf, -1) along the slot axis with `row` as the newest entry,
    broadcast to the row's lanes: [..., W, N+1]."""
    head = buf[..., 1:, :]
    head = head.expand(row.shape[:-1] + head.shape[-2:])
    return torch.cat([head, row[..., None, :]], dim=-2)


@dataclasses.dataclass(frozen=True)
class PersistenceForecaster:
    """forecast(t+h) = observation(t) for every h."""

    H: int = 8

    def init(self, N: int, *, key=None, table=None, error=None, device=DEFAULT_DEVICE):
        del key, table, error
        return _zeros((N + 1,), device)

    def update(self, carry, row):
        del carry
        return row.float()

    def predict(self, carry, t):
        del t
        return _tile_last(carry, self.H)


@dataclasses.dataclass(frozen=True)
class SeasonalNaiveForecaster:
    """forecast(t+h) = observation(t+h-period), the previous day's value
    at the same slot of the day; persistence until a full period has
    been observed. `period` defaults to the 48 half-hour slots a day of
    `diurnal_table` and the ESO traces."""

    H: int = 8
    period: int = 48

    def init(self, N: int, *, key=None, table=None, error=None, device=DEFAULT_DEVICE):
        del key, table, error
        return _zeros((self.period, N + 1), device), 0

    def update(self, carry, row):
        buf, count = carry
        return _push(buf, row.float()), count + 1

    def predict(self, carry, t):
        del t
        buf, count = carry
        if count < self.period:
            return _tile_last(buf[..., -1, :], self.H)
        # after k >= period updates buf[-1] = obs(t), buf[0] = obs(t-period+1),
        # so obs(t+h-period) sits at index h-1 (h in 1..period)
        h = torch.arange(self.H - 1, device=buf.device) % self.period
        return torch.cat([buf[..., -1:, :], buf.index_select(-2, h)], dim=-2)


@dataclasses.dataclass(frozen=True)
class EWMAForecaster:
    """Exponentially weighted moving-average level, forecast flat ahead;
    row 0 stays the raw last observation (the policy's known present)."""

    H: int = 8
    alpha: float = 0.3

    def init(self, N: int, *, key=None, table=None, error=None, device=DEFAULT_DEVICE):
        del key, table, error
        z = _zeros((N + 1,), device)
        return z, z, 0  # (level, last row, count)

    def update(self, carry, row):
        level, _, count = carry
        row = row.float()
        if count == 0:
            return row, row, 1
        a = torch.full((), self.alpha, dtype=torch.float32, device=row.device)
        keep = torch.full((), 1.0 - self.alpha, dtype=torch.float32, device=row.device)
        return fma_f32(a, row, keep * level), row, count + 1

    def predict(self, carry, t):
        del t
        level, last, _ = carry
        ahead = level[..., None, :].expand(level.shape[:-1] + (self.H - 1, level.shape[-1]))
        return torch.cat([last[..., None, :], ahead], dim=-2)


@dataclasses.dataclass(frozen=True)
class RidgeARForecaster:
    """Per-region AR(p) with intercept, refit every slot by ridge least
    squares on the last `window` observations, rolled forward H-1 steps:
    theta = (X'X + ridge*I)^-1 X'y per region (`solve_gauss`, batched
    over lanes and regions, the Gram sums in row order), each prediction
    fed back into the lag window and clipped at 0. Persistence until the
    window holds `window` real observations."""

    H: int = 8
    lags: int = 8
    window: int = 64
    ridge: float = 1.0

    def init(self, N: int, *, key=None, table=None, error=None, device=DEFAULT_DEVICE):
        del key, table, error
        if self.window < 2 * self.lags:
            raise ValueError(f"window={self.window} is too short to fit AR({self.lags})")
        return _zeros((self.window, N + 1), device), 0

    def update(self, carry, row):
        buf, count = carry
        return _push(buf, row.float()), count + 1

    def _fit(self, buf: torch.Tensor) -> torch.Tensor:
        """buf [..., window, N+1] -> theta [..., lags+1, N+1]."""
        p, W = self.lags, self.window
        cols = buf.transpose(-1, -2)                                    # [..., N+1, W]
        idx = (torch.arange(W - p, device=buf.device)[:, None]
               + torch.arange(p, device=buf.device)[None, :])
        X = cols[..., idx]                                              # [..., N+1, W-p, p]
        X = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)         # [..., N+1, W-p, p+1]
        Xy = torch.cat([X, cols[..., p:, None]], dim=-1)                # [..., N+1, W-p, p+2]
        # [X'X | X'y]: one FMA a row, in row order, as XLA:CPU's dot
        # computes X'X and X'y (bitwise; elementwise, so batch-invariant)
        G = _fma_rows(X[..., :, :, None], Xy[..., :, None, :], -3)      # [..., N+1, p+1, p+2]
        eye = torch.eye(p + 1, p + 2, dtype=buf.dtype, device=buf.device)
        theta = solve_gauss(G + self.ridge * eye)                       # [..., N+1, p+1]
        return theta.transpose(-1, -2)

    def predict(self, carry, t):
        del t
        buf, count = carry
        if count < self.window:
            return _tile_last(buf[..., -1, :], self.H)
        theta = self._fit(buf)
        win = buf[..., -self.lags:, :]
        ahead = []
        for _ in range(self.H - 1):
            nxt = torch.clamp_min(_sum_rows(win * theta[..., : self.lags, :], -2)
                                  + theta[..., -1, :], 0.0)
            win = _push(win, nxt)
            ahead.append(nxt)
        return torch.stack([buf[..., -1, :]] + ahead, dim=-2)
