"""Carbon-intensity sources (paper §V scenarios), in PyTorch.

Counterpart of `repro.core.carbon`. A source is a callable
`(t: int, key, device) -> (Ce 0-d tensor, Cc [N] tensor)`, `key` a
threefry key on the device (`repro_torch.random`; [F, 2] for F lanes,
which give Ce [F] and Cc [F, N]):

  * RandomCarbonSource     -- Ce(t), Cc_n(t) ~ U{0..700} i.i.d.   (Fig. 2)
  * UKRegionalTraceSource  -- the synthetic stand-in for the National
    Grid ESO regional traces of Fig. 3 (diurnal cycle, wind fronts,
    region means, noise); `from_eso_csv` loads real exports.
  * ConstantCarbonSource / TableCarbonSource -- tests and playback.

Sources that hold data have `to(device)`, which stages it on the device
once; the simulator calls it before its loop so that no slot copies host
data. Random draws are JAX's threefry streams, each one launch of the
draw kernel with the slot folded in (`ops.threefry_draw`): the same key
gives the JAX source's values bitwise, the UK source's Gaussian noise
included (the draw's `normal` finish, XLA's erfinv and log1p).
RandomCarbonSource also draws a block of slots in one launch (`block`,
which the simulators' loops use). The UK source, whose float32
emulation of XLA's sin takes hundreds of launches, renders 256 slots a
pass (their noise one draw) and serves rows of it.

The table helpers `diurnal_table` and `bursty_table` are numpy, copied
from the JAX module, so they give bitwise the same tables.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core import rng
from repro_torch.core.queueing import DTYPE
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.numerics import sincos_glibc


class DeviceCache:
    """Per-device copies of a source's constant tensors (made by the
    subclass's `_tensors(device)`), filled by `to(device)` or on first
    use."""

    def _cached(self, device, make):
        cache = self.__dict__.setdefault("_device_cache", {})
        device = torch.device(device)
        if device not in cache:
            cache[device] = make(device)
        return cache[device]

    def to(self, device):
        self._tensors(device)
        return self


@dataclasses.dataclass(frozen=True)
class RandomCarbonSource:
    """Paper Fig. 2: each intensity i.i.d. uniform over {0..cmax}."""

    N: int
    cmax: int = 700

    def __call__(self, t: int, key, device) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.block(t, None, key, device)

    def block(self, t0: int, count, key, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Slots t0..t0+count-1 -> (Ce [count, ...], Cc [count, ..., N])
        (count None: slot t0). ke, kc = split(fold_in(key, t)); Ce =
        randint(ke, ()), Cc = randint(kc, (N,)): one draw, the edge from
        the first half."""
        vals = ops.threefry_draw(rng.key_of(key, device), t0, self.N + 1, finish="randint_f32",
                                 seg=1, minval=0, maxval=self.cmax + 1, count=count)
        return vals[..., 0], vals[..., 1:]

    @property
    def slot_width(self) -> int:
        return self.N + 1


@dataclasses.dataclass(frozen=True)
class ConstantCarbonSource(DeviceCache):
    N: int
    Ce: float = 200.0
    Cc: float = 200.0

    def __post_init__(self):
        if int(self.N) < 1:
            raise ValueError(f"ConstantCarbonSource needs N >= 1 clouds, got N={self.N}")
        if np.shape(self.Ce) != ():
            raise ValueError(f"Ce must be a scalar intensity, got shape {np.shape(self.Ce)}")
        if np.shape(self.Cc) not in ((), (int(self.N),)):
            raise ValueError(
                f"Cc must be a scalar or [N={self.N}] intensities, got shape {np.shape(self.Cc)}"
            )

    def _tensors(self, device):
        def make(dev):
            Cc = torch.as_tensor(np.asarray(self.Cc, np.float32), device=dev)
            return (torch.as_tensor(np.float32(self.Ce), device=dev),
                    torch.broadcast_to(Cc, (self.N,)))
        return self._cached(device, make)

    def __call__(self, t: int, key, device):
        del t, key
        return self._tensors(device)


# 2022-ish UK regional profile parameters: (mean gCO2/kWh, diurnal
# amplitude, wind sensitivity). Region 0 backs the edge server; 1..5 back
# the five clouds. Cloud columns past the last region reuse it, as the
# JAX source's clamped gather does.
_UK_REGIONS = (
    (180.0, 60.0, 120.0),  # London          (edge)
    (45.0, 20.0, 35.0),    # North Scotland  (hydro/wind heavy)
    (330.0, 80.0, 150.0),  # South Wales     (gas heavy)
    (210.0, 70.0, 130.0),  # Midlands
    (120.0, 50.0, 90.0),   # North West
    (260.0, 75.0, 140.0),  # South East
)

_SLOTS_PER_DAY = 48  # 30-minute slots, as in the ESO dataset
_BLOCK = 256  # UK trace slots rendered per pass (one draw for all of them)


@dataclasses.dataclass(frozen=True)
class UKRegionalTraceSource(DeviceCache):
    """Synthetic stand-in for National Grid ESO regional traces (Fig. 3).

    Deterministic in (seed, t). The structure and the noise's keys are
    the JAX source's (`fold_in(fold_in(PRNGKey(seed), t), region)`), and
    so are its float32 operations, one rounding each (JAX renders the
    trace under an eager `vmap`, where nothing is contracted), with
    glibc's `sinf` (`numerics.sincos_glibc`) and XLA's erfinv and log1p:
    the trace is the JAX package's bitwise."""

    N: int = 5
    seed: int = 2022
    regions: tuple = _UK_REGIONS

    def _tensors(self, device):
        def make(dev):
            last = len(self.regions) - 1
            rows = [self.regions[min(r, last)] for r in range(self.N + 1)]
            params = torch.as_tensor(np.asarray(rows, np.float32), device=dev)
            region = torch.arange(self.N + 1, dtype=DTYPE, device=dev)
            return params, region, R.PRNGKey(self.seed, device=dev)
        return self._cached(device, make)

    def _rows(self, start: int, count: int, device) -> torch.Tensor:
        """The trace of slots start..start+count-1, [count, N+1], float32
        op by op as JAX computes it (sin is glibc's sinf), the noise one
        draw for every row. Every divisor is a device tensor: CUDA turns a
        division by a Python scalar into a multiply by its reciprocal."""
        params, region, base = self._tensors(device)
        mean, amp, wind = params[:, 0], params[:, 1], params[:, 2]

        def f32(v):  # a float32 scalar filled on the device: no copy from the host
            return torch.full((), v, dtype=DTYPE, device=params.device)

        t = torch.arange(start, start + count, device=params.device)
        tm, tt = (t % _SLOTS_PER_DAY).to(DTYPE)[:, None], t.to(DTYPE)[:, None]
        day_phase = (f32(2.0 * math.pi) * tm) / f32(_SLOTS_PER_DAY)
        # demand peaks around 18:00 -> phase shift; solar dip mid-day
        diurnal = amp * (_sinf(day_phase - f32(2.0 * math.pi * 18.0 / 24.0))
                         + f32(0.3) * _sinf(2.0 * day_phase))
        # wind fronts: slow sinusoids with region-coherent + national terms
        national = _sinf((f32(2 * math.pi) * tt) / f32(_SLOTS_PER_DAY * 3.3) + f32(1.7))
        regional = _sinf((f32(2 * math.pi) * tt) / f32(_SLOTS_PER_DAY * 2.1) + region)
        front = wind * (f32(0.7) * national + f32(0.3) * regional)
        # normal(fold_in(fold_in(PRNGKey(seed), t), region)): one draw for
        # every slot of the block
        noise = ops.threefry_draw(base, start, self.N + 1, finish="normal", fold_each=True,
                                  count=count)
        return torch.clamp(((mean + diurnal) + front) + 25.0 * noise, 5.0, 700.0)

    def __call__(self, t: int, key, device):
        """Slot t's row, from the block of _BLOCK slots rendered at once
        that holds it (the last block is kept per device)."""
        del key  # the trace is a function of (self.seed, t), as in JAX
        blocks = self.__dict__.setdefault("_blocks", {})
        dev, b = torch.device(device), t // _BLOCK
        held = blocks.get(dev)
        if held is None or held[0] != b:
            held = blocks[dev] = (b, self._rows(b * _BLOCK, _BLOCK, dev))
        row = held[1][t - b * _BLOCK]
        return row[0], row[1:]

    def table(self, T: int, device=DEFAULT_DEVICE) -> torch.Tensor:
        """Slots 0..T-1 as a [T, N+1] tensor (each row the slot's
        `__call__`, bitwise)."""
        return self._rows(0, T, resolve_device(device))


def _sinf(x):
    return sincos_glibc(x)[0]


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: array field
class TableCarbonSource(DeviceCache):
    """Plays back a precomputed table. table: [T, N+1] (or [F, T, N+1]
    for F lanes, as the fleet holds them); column 0 = edge; rows repeat
    modulo T."""

    table: object

    def __post_init__(self):
        shape = getattr(self.table, "shape", None)
        if shape is None or len(shape) not in (2, 3):
            raise ValueError(
                "TableCarbonSource.table must be a [T, N+1] array (col 0 = edge), got "
                f"{'no shape' if shape is None else f'shape {tuple(shape)}'}"
            )
        shape = shape[-2:]
        if shape[0] < 1 or shape[1] < 2:
            raise ValueError(
                f"TableCarbonSource.table shape {tuple(shape)} needs at least 1 row "
                "and 2 columns (edge + >=1 cloud)"
            )

    @property
    def N(self) -> int:
        return self.table.shape[-1] - 1

    def _tensors(self, device):
        return self._cached(device, lambda dev: torch.as_tensor(self.table, dtype=DTYPE, device=dev))

    def __call__(self, t: int, key, device):
        del key
        tab = self._tensors(device)
        row = tab[..., t % tab.shape[-2], :]
        return row[..., 0], row[..., 1:]


def from_eso_csv(path: str, n_regions: int) -> TableCarbonSource:
    """Loads a National Grid ESO regional forecast CSV export: datetime,
    then one intensity column per region (gCO2/kWh). The first region
    backs the edge, the next `n_regions` the clouds. Malformed rows are
    skipped; a file with no usable row raises."""
    rows = []
    skipped = 0
    expected_cols = n_regions + 2  # datetime + edge + n_regions clouds
    with open(path) as f:
        f.readline()  # header
        for line in f:
            if not line.strip():
                continue
            parts = line.strip().split(",")
            if len(parts) < expected_cols:
                skipped += 1
                continue
            try:
                rows.append([float(x) for x in parts[1:expected_cols]])
            except ValueError:
                skipped += 1
    if not rows:
        raise ValueError(
            f"{path}: no usable data rows (expected >= {expected_cols} comma-separated "
            f"columns: datetime, edge, {n_regions} cloud regions; skipped {skipped} "
            "malformed row(s))"
        )
    return TableCarbonSource(table=np.asarray(rows, np.float32))


# Scenario table generators: numpy, copied from the JAX module, so the
# same rng gives bitwise the same [T, N+1] table in both packages.


def diurnal_table(T: int, N: int, rng: np.random.Generator, mean: float = 220.0,
                  amp: float = 90.0, noise: float = 20.0,
                  slots_per_day: int = _SLOTS_PER_DAY) -> np.ndarray:
    """Smooth day/night cycle with per-region phase/mean jitter."""
    t = np.arange(T)[:, None]
    phase = rng.uniform(0, 2 * np.pi, (1, N + 1))
    means = mean * rng.uniform(0.6, 1.4, (1, N + 1))
    day = 2 * np.pi * (t % slots_per_day) / slots_per_day
    tab = means + amp * np.sin(day - phase) + noise * rng.normal(size=(T, N + 1))
    return np.clip(tab, 5.0, 700.0).astype(np.float32)


def bursty_table(T: int, N: int, rng: np.random.Generator, base: float = 120.0,
                 spike: float = 450.0, p_spike: float = 0.05,
                 spike_len: int = 6) -> np.ndarray:
    """Low baseline with rare, multi-slot, region-local intensity spikes."""
    tab = base * rng.uniform(0.7, 1.3, (T, N + 1))
    starts = rng.random((T, N + 1)) < p_spike
    for dt in range(spike_len):
        rolled = np.roll(starts, dt, axis=0)
        rolled[:dt] = False
        tab = np.where(rolled, tab + spike * (1 - dt / spike_len), tab)
    tab += 15.0 * rng.normal(size=(T, N + 1))
    return np.clip(tab, 5.0, 700.0).astype(np.float32)


def uk_regional_table(T: int, N: int, seed: int = 2022, rotate: int = 0,
                      device=DEFAULT_DEVICE) -> np.ndarray:
    """Materializes UKRegionalTraceSource with the ESO region parameters
    rotated by `rotate` (a fleet of rotations covers every assignment of
    regions to the edge and clouds)."""
    R = len(_UK_REGIONS)
    regions = tuple(_UK_REGIONS[(i + rotate) % R] for i in range(N + 1))
    return UKRegionalTraceSource(N=N, seed=seed, regions=regions).table(T, device).cpu().numpy()


def materialize(source, T: int, seed=0, device=DEFAULT_DEVICE) -> np.ndarray:
    """Renders any source to a [T, N+1] numpy table; `seed` an int
    (`PRNGKey(seed)`, the JAX function's default key at 0) or a key."""
    device = resolve_device(device)
    key = rng.key_of(seed, device)
    rows = []
    for t in range(T):
        Ce, Cc = source(t, key, device)
        rows.append(torch.cat([Ce.reshape(1), Cc]))
    return torch.stack(rows).cpu().numpy()
