"""Offline forecast evaluation (counterpart of `repro.forecast.metrics`):
replays a trace table through a forecaster as if it arrived live
(update, then predict, as the simulator wires it) and scores every
forecast against the realized future."""
from __future__ import annotations

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


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
    float64."""
    dev = resolve_device(device)
    table = torch.as_tensor(table, dtype=torch.float32).to(dev)
    T, H = table.shape[0], forecaster.H
    fc = rolling_forecasts(forecaster, table, key=key, device=dev)  # [T, H, N+1]
    h = torch.arange(1, H, device=dev)
    ts = torch.arange(T, device=dev)[:, None]
    tgt = ts + h[None, :]                                            # [T, H-1]
    valid = (tgt < T) & (ts >= burn_in)
    truth = table[tgt.clamp(0, T - 1)]                               # [T, H-1, N+1]
    err = (fc[:, 1:, :] - truth).double()
    # float64 sums, rounded once: JAX's float32 sums (XLA:CPU's windowed
    # order) sit about 1e-6 from these on a few thousand terms
    w = valid[..., None].expand(err.shape).double()
    denom = torch.clamp_min(torch.sum(w), 1.0)
    mae = torch.sum(torch.abs(err) * w) / denom
    rmse = torch.sqrt(torch.sum(err**2 * w) / denom)
    per_lead = torch.clamp_min(torch.sum(w, dim=(0, 2)), 1.0)
    mae_per_lead = torch.sum(torch.abs(err) * w, dim=(0, 2)) / per_lead
    return {"mae": mae.float(), "rmse": rmse.float(), "mae_per_lead": mae_per_lead.float()}
