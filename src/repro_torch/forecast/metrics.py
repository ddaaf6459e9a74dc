"""Offline forecast evaluation (counterpart of `repro.forecast.metrics`):
replays a trace table through a forecaster as if it arrived live
(update, then predict, as the simulator wires it) and scores every
forecast against the realized future."""
from __future__ import annotations

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.numerics import sqrt_rn, xla_sum


def rolling_forecasts(forecaster, table, *, key=None, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Replays `table` [T, N+1] through `forecaster` on `device`; returns
    the forecasts [T, H, N+1] (entry t is issued after observing row t)."""
    dev = resolve_device(device)
    table = torch.as_tensor(table, dtype=torch.float32).to(dev)
    N = table.shape[1] - 1
    carry = forecaster.init(N, key=key, table=table, device=dev)
    out = []
    for t in range(table.shape[0]):
        carry = forecaster.update(carry, table[t])
        out.append(forecaster.predict(carry, t))
    return torch.stack(out)


def forecast_errors(forecaster, table, *, key=None, burn_in: int = 0,
                    device=DEFAULT_DEVICE) -> dict:
    """MAE / RMSE of `forecaster` on `table`, scored on leads h >= 1 only
    (lead 0 is the observed present). Forecasts whose target slot falls
    off the table's end are excluded, and `burn_in` drops the first
    slots, where history-based forecasters still warm up. Returns 0-d
    float32 tensors and the per-lead MAE profile [H-1], summed in
    float32 in XLA:CPU's order (`xla_sum`)."""
    dev = resolve_device(device)
    table = torch.as_tensor(table, dtype=torch.float32).to(dev)
    T, H = table.shape[0], forecaster.H
    fc = rolling_forecasts(forecaster, table, key=key, device=dev)  # [T, H, N+1]
    h = torch.arange(1, H, device=dev)
    ts = torch.arange(T, device=dev)[:, None]
    tgt = ts + h[None, :]                                            # [T, H-1]
    valid = (tgt < T) & (ts >= burn_in)
    truth = table[tgt.clamp(0, T - 1)]                               # [T, H-1, N+1]
    err = fc[:, 1:, :] - truth
    w = valid[..., None].expand(err.shape).float()
    total = lambda x: xla_sum(x.reshape(T, -1))  # noqa: E731
    per_lead = lambda x: xla_sum(x.permute(1, 0, 2))  # noqa: E731  [H-1]
    denom = torch.clamp_min(total(w), 1.0)
    mae = total(torch.abs(err) * w) / denom
    rmse = sqrt_rn(total(err * err * w) / denom)
    mae_per_lead = per_lead(torch.abs(err) * w) / torch.clamp_min(per_lead(w), 1.0)
    return {"mae": mae, "rmse": rmse, "mae_per_lead": mae_per_lead}
