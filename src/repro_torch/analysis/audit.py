"""Dtype and host-sync auditor for the port (counterpart of
`repro.analysis.audit`).

Runs every registered (policy x scenario) combination -- the JAX audit's
registry at its sizes -- through the port's loops on the device it is
given, and checks the invariants the port's parity and speed rest on:

  dtype      every carried state field (what the policy sees each slot:
             queues, intensities, arrivals, the fault and deadline views,
             forecasts, link queues) and every recorded field of the
             result is float32, int32, uint32 or bool. Documented
             exceptions: `KEY_FIELDS`, the threefry keys, which are int64
             tensors holding uint32 pairs (`repro_torch.random`), and
             `INDEX_FIELDS`, the WAN graph's route indices, int64 because
             torch's gather, scatter and index_add take int64 indices
             (constants of a run, int32 in the JAX package).
  float64    the same combo run under `torch.set_default_dtype(torch.
             float64)` gives the same dtypes everywhere: no tensor takes
             the default dtype where the port means float32 (the
             counterpart of JAX's x64 re-trace).
  host-sync  no host sync inside a slot (a `repro.slot` span of the
             loops): a TorchDispatchMode counts `aten._local_scalar_dense`
             (`.item()`, `float(t)`, a tensor as a bool), copies from the
             card to the host, and the ops whose output size depends on
             the data (`nonzero`, `masked_select`, `unique`), which wait
             for the card too. Calls into a kernel's plain version
             (through `kernels.ops`) are not counted: on the card each is
             one launch. This is the counterpart of "no host callbacks".
             The one sanctioned exception is the streamed telemetry's
             copy to its channel (`repro.stream_flush`), allowed only in
             the combos that stream (`streams`).

JAX's `retrace_audit` has no counterpart: eager PyTorch compiles no
program, so there is no signature to retrace. Weak types have none
either.

`audit_all()` runs everything; `python -m repro_torch.analysis --audit`
is the CLI entry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import traceback
from typing import Callable, Dict, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import DEFAULT_DEVICE, resolve_device

ALLOWED_DTYPES = {torch.float32, torch.int32, torch.bool} | (
    {torch.uint32} if hasattr(torch, "uint32") else set())
# Fields allowed another dtype: the threefry keys (int64 holding uint32
# pairs), the policy's SlotKey and the loops' keys; the graph's indices.
KEY_FIELDS = ("key",)
INDEX_FIELDS = ("graph.dest", "graph.primary", "graph.region")

AUDIT_T = 8          # slots run per combo
AUDIT_M, AUDIT_N = 4, 3
AUDIT_TC = 24
AUDIT_PER_KIND = 2

_SYNC_OPS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::nonzero_static",
             "aten::masked_select", "aten::_unique2", "aten::unique_dim",
             "aten::unique_consecutive", "aten::_unique")


@dataclasses.dataclass(frozen=True)
class AuditViolation:
    combo: str
    check: str   # "dtype" | "float64" | "host-sync" | "run"
    message: str

    def __str__(self) -> str:
        return f"{self.combo}: [{self.check}] {self.message}"


class Combo(NamedTuple):
    """One (policy, forecaster, scenario-family) combination."""

    name: str
    policy_key: str
    scenario: str
    make_policy: Callable  # () -> policy
    forecaster: object
    fleet: object          # FleetScenario
    record: object         # "full" | "summary" | int stride
    telemetry: object = None


# ---------------------------------------------------------------------------
# Registry enumeration: JAX's, with one score route (`carbon_scores`)
# where JAX has a reference and a Pallas one.


def _policy_factories():
    from repro_torch.core.extensions import ThresholdPolicy
    from repro_torch.core.policies import (
        CarbonIntensityPolicy,
        ExactDPPPolicy,
        LookaheadDPPPolicy,
        QueueLengthPolicy,
        RandomPolicy,
    )
    from repro_torch.forecast import SeasonalNaiveForecaster

    fc = SeasonalNaiveForecaster(H=4, period=6)
    return [
        ("ci", lambda: CarbonIntensityPolicy(), None),
        ("queue-length", lambda: QueueLengthPolicy(), None),
        ("lookahead", lambda: LookaheadDPPPolicy(H=4), fc),
        ("threshold", lambda: ThresholdPolicy(), None),
        ("random", lambda: RandomPolicy(), None),
        ("exact-dpp", lambda: ExactDPPPolicy(grid=32), None),
    ]


def _wan_policy_factories():
    from repro_torch.core.policies import CarbonIntensityPolicy
    from repro_torch.forecast import SeasonalNaiveForecaster
    from repro_torch.network import NetworkAwareDPPPolicy, StaticRoutePolicy

    fc = SeasonalNaiveForecaster(H=4, period=6)
    return [
        ("aware", lambda: NetworkAwareDPPPolicy(), None),
        ("blind", lambda: StaticRoutePolicy(CarbonIntensityPolicy()), None),
        ("aware-lookahead", lambda: NetworkAwareDPPPolicy(H=4), fc),
    ]


def iter_combos(per_kind: int = AUDIT_PER_KIND, device=DEFAULT_DEVICE) -> List[Combo]:
    """Every policy crossed with every registered scenario (plain
    fleets) and every registered topology (WAN fleets), at audit size,
    plus the recording modes, the forecast-error lanes and the fault,
    telemetry, deadline and streaming combos of the JAX registry."""
    from repro_torch.configs.fleet_scenarios import (
        NETWORK_SCENARIOS,
        SCENARIOS,
        build_fleet,
        build_network_fleet,
        with_deadlines,
        with_faults,
    )
    from repro_torch.core.policies import CarbonIntensityPolicy
    from repro_torch.core.simulator import sweep_forecast_errors
    from repro_torch.deadlines import EDDPolicy, SlackThresholdPolicy, WaitAwhilePolicy
    from repro_torch.faults import StalenessGuardPolicy
    from repro_torch.forecast import ClairvoyantTableForecaster, SeasonalNaiveForecaster
    from repro_torch.network import NetworkAwareDPPPolicy
    from repro_torch.telemetry import StreamConfig, TelemetryConfig

    dev = resolve_device(device)
    size = dict(per_kind=per_kind, M=AUDIT_M, N=AUDIT_N, Tc=AUDIT_TC, seed=0, device=dev)
    combos: List[Combo] = []

    def add(policy_key, scen, make, fleet, record="full", fc=None, tel=None, name=None):
        combos.append(Combo(name or f"{policy_key}@{scen}", policy_key, scen, make, fc, fleet,
                            record, tel))

    fleets = {kind: build_fleet([kind], **size) for kind in SCENARIOS}
    for policy_key, make, fc in _policy_factories():
        for kind, fleet in fleets.items():
            add(policy_key, kind, make, fleet, fc=fc)
    base = fleets["diurnal-slack"]
    ci = _policy_factories()[0][1]
    for record in ("summary", 2):
        add("ci", "diurnal-slack", ci, base, record=record,
            name=f"ci@diurnal-slack/record={record}")
    add("lookahead", "diurnal-slack+err", _policy_factories()[2][1],
        sweep_forecast_errors(base, bias=0.05, noise=0.1), fc=ClairvoyantTableForecaster(H=4),
        name="lookahead/clairvoyant-err@diurnal-slack")

    wan = {kind: build_network_fleet([kind], **size) for kind in NETWORK_SCENARIOS}
    for policy_key, make, fc in _wan_policy_factories():
        for kind, fleet in wan.items():
            add(policy_key, kind, make, fleet, fc=fc)

    blackout = with_faults(base, "regional-blackout")
    brownout = with_faults(base, "telemetry-brownout")
    flappy = with_faults(wan["congested-uplink"], "flappy-uplink")
    guard_ci = lambda: StalenessGuardPolicy(CarbonIntensityPolicy())  # noqa: E731
    guard_aware = lambda: StalenessGuardPolicy(NetworkAwareDPPPolicy())  # noqa: E731
    for policy_key, make, scen, fleet, record in (
        ("ci", ci, "regional-blackout", blackout, "full"),
        ("guard-ci", guard_ci, "regional-blackout", blackout, "full"),
        ("guard-ci", guard_ci, "telemetry-brownout", brownout, "full"),
        ("guard-ci", guard_ci, "telemetry-brownout/summary", brownout, "summary"),
        ("queue-length", _policy_factories()[1][1], "telemetry-brownout", brownout, "full"),
        ("aware", lambda: NetworkAwareDPPPolicy(), "flappy-uplink", flappy, "full"),
        ("guard-aware", guard_aware, "flappy-uplink", flappy, "full"),
    ):
        add(policy_key, scen, make, fleet, record=record,
            name=f"{policy_key}@diurnal-slack+{scen}")

    tcfg = TelemetryConfig()
    for policy_key, make, scen, fleet, record in (
        ("ci", ci, "diurnal-slack+taps", base, "full"),
        ("ci", ci, "diurnal-slack+taps/summary", base, "summary"),
        ("ci", ci, "diurnal-slack+taps/stride", base, 2),
        ("aware", lambda: NetworkAwareDPPPolicy(), "congested-uplink+taps",
         wan["congested-uplink"], "full"),
        ("guard-ci", guard_ci, "telemetry-brownout+taps", brownout, "full"),
        ("guard-aware", guard_aware, "flappy-uplink+taps", flappy, "full"),
    ):
        add(policy_key, scen, make, fleet, record=record, tel=tcfg)

    tight = with_deadlines(base, "tight-uniform")
    shed = with_deadlines(fleets["overload"], "shed-overload")
    tight_blackout = with_deadlines(blackout, "tight-uniform")
    fc4 = SeasonalNaiveForecaster(H=4, period=6)
    for policy_key, make, scen, fleet, record, fc, tel in (
        ("slack", lambda: SlackThresholdPolicy(), "tight-uniform", tight, "full", None, None),
        ("edd", lambda: EDDPolicy(), "tight-uniform", tight, "full", None, None),
        ("waitawhile", lambda: WaitAwhilePolicy(H=4), "tight-uniform", tight, "full", fc4,
         None),
        ("ci", ci, "overload+shed", shed, "summary", None, None),
        ("guard-slack", lambda: StalenessGuardPolicy(SlackThresholdPolicy()),
         "tight-uniform+regional-blackout", tight_blackout, "full", None, None),
        ("slack", lambda: SlackThresholdPolicy(), "tight-uniform+taps", tight, "full", None,
         tcfg),
    ):
        add(policy_key, scen, make, fleet, record=record, fc=fc, tel=tel)

    scfg = StreamConfig(taps=tcfg, flush_every=4, channel="audit")  # divides AUDIT_T
    for policy_key, make, scen, fleet, record in (
        ("ci", ci, "diurnal-slack+stream", base, "full"),
        ("ci", ci, "diurnal-slack+stream/summary", base, "summary"),
        ("aware", lambda: NetworkAwareDPPPolicy(), "congested-uplink+stream",
         wan["congested-uplink"], "full"),
        ("guard-ci", guard_ci, "telemetry-brownout+stream", brownout, "full"),
    ):
        add(policy_key, scen, make, fleet, record=record, tel=scfg)
    return combos


# ---------------------------------------------------------------------------
# What a run carries, records and syncs


def leaves(obj, path: str = ""):
    """(path, tensor) for every tensor in nested tuples, NamedTuples,
    dataclasses, dicts and lists."""
    if torch.is_tensor(obj):
        yield path, obj
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for name in obj._fields:
            yield from leaves(getattr(obj, name), f"{path}.{name}" if path else name)
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            yield from leaves(x, f"{path}[{i}]")
    elif isinstance(obj, dict):
        for k, x in obj.items():
            yield from leaves(x, f"{path}.{k}" if path else str(k))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{path}.{f.name}" if path else f.name)


class _Watched:
    """Wraps a policy: records the dtype of everything it is handed each
    slot (the carried state) and of the action it returns."""

    def __init__(self, policy, dtypes: Dict[str, set]):
        self.policy, self.dtypes = policy, dtypes

    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, **kw):
        seen = dict(state=state, spec=spec, Ce=Ce, Cc=Cc, arrivals=arrivals, key=key, **kw)
        for path, x in leaves(seen, "slot"):
            self.dtypes.setdefault(path, set()).add(x.dtype)
        act = self.policy(state, spec, Ce, Cc, arrivals, key, **kw)
        for path, x in leaves(act, "slot.action"):
            self.dtypes.setdefault(path, set()).add(x.dtype)
        return act


class HostSyncs(TorchDispatchMode):
    """Counts the host syncs made inside `repro.slot` spans, outside the
    kernels' plain versions (see `plain_versions_unseen`) and, where
    `allow_flush`, outside `repro.stream_flush` spans. Each finding keeps
    the op and the innermost frame of the port that made it."""

    def __init__(self, allow_flush: bool = False):
        super().__init__()
        self.allow_flush = allow_flush
        self.labels: list = []   # the open record_function spans' labels
        self.plain = 0
        self.found: List[str] = []
        self.flushed = 0

    def _sync(self, func, args, kwargs) -> bool:
        name = func._schema.name  # the op without its overload
        if name in _SYNC_OPS:
            return True
        if name == "aten::_to_copy":
            src, dst = args[0], kwargs.get("device")
            return src.device.type == "cuda" and dst is not None and \
                torch.device(dst).type == "cpu"
        if name == "aten::copy_":
            return args[0].device.type == "cpu" and args[1].device.type == "cuda"
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name  # the op without its overload
        out = func(*args, **kwargs)
        if name == "profiler::_record_function_enter_new":
            self.labels.append(args[0])
        elif name == "profiler::_record_function_exit":
            if self.labels:  # spans nest: the innermost one closes
                self.labels.pop()
        elif self.plain == 0 and self._sync(func, args, kwargs):
            if "repro.slot" in self.labels:
                if self.allow_flush and "repro.stream_flush" in self.labels:
                    self.flushed += 1
                else:
                    self.found.append(f"{name} at {_port_frame()}")
        return out


def _port_frame() -> str:
    for fr in reversed(traceback.extract_stack()):
        if "repro_torch" in fr.filename and "analysis" not in fr.filename:
            return f"{fr.filename.split('src/')[-1]}:{fr.lineno} ({fr.name})"
    return "?"


@contextlib.contextmanager
def plain_versions_unseen(mode: HostSyncs):
    """Within the block, every call that `kernels.ops` sends to a plain
    version runs with `mode` paused: on the card it is one launch."""
    from repro_torch.kernels import ops

    real = ops._pick

    def pick(x, plain, cuda, what):
        fn = real(x, plain, cuda, what)
        if fn is not plain:
            return fn

        def unseen(*a, **k):
            mode.plain += 1
            try:
                return fn(*a, **k)
            finally:
                mode.plain -= 1

        return unseen

    ops._pick = pick
    try:
        yield
    finally:
        ops._pick = real


@contextlib.contextmanager
def default_dtype(dtype):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def streams(combo: Combo) -> bool:
    """Whether the combo streams its telemetry: the only combos allowed a
    copy to the host inside a slot, the flush's."""
    from repro_torch.telemetry import StreamConfig

    return isinstance(combo.telemetry, StreamConfig)


def run_combo(combo: Combo, device=DEFAULT_DEVICE, policy=None):
    """One fleet run of the combo -> ({field path: its dtypes}, [host syncs
    found in a slot], result, error). A failed run keeps what it saw up
    to the failure, with the exception as `error` (else None). `policy`
    replaces the combo's (a test's injected fault)."""
    from repro_torch.core.simulator import simulate_fleet

    dev = resolve_device(device)
    dtypes: Dict[str, set] = {}
    watched = _Watched(combo.make_policy() if policy is None else policy, dtypes)
    mode = HostSyncs(allow_flush=streams(combo))
    res = err = None
    try:
        with plain_versions_unseen(mode), mode:
            res = simulate_fleet(watched, combo.fleet, AUDIT_T, 0, record=combo.record,
                                 device=dev, forecaster=combo.forecaster,
                                 telemetry=combo.telemetry)
    except Exception as e:  # noqa: BLE001 -- a failed run is itself a finding
        err = e
    for path, x in leaves(res, "result"):
        dtypes.setdefault(path, set()).add(x.dtype)
    return dtypes, mode.found, res, err


def _excepted(path: str) -> bool:
    parts = path.replace("[", ".").split(".")
    return any(part in KEY_FIELDS for part in parts) or any(
        path.endswith(f) for f in INDEX_FIELDS)


def audit_combo(combo: Combo, device=DEFAULT_DEVICE, policy=None) -> List[AuditViolation]:
    """The three checks on one combo: dtypes, the same dtypes under a
    float64 default, and no host sync inside a slot."""
    out: List[AuditViolation] = []
    dtypes, syncs, _, err = run_combo(combo, device, policy)
    if err is not None:
        out.append(AuditViolation(combo.name, "run", f"the run failed: {err!r}"))
    for path, dts in sorted(dtypes.items()):
        for dt in sorted(dts - ALLOWED_DTYPES, key=str):
            if not _excepted(path):
                out.append(AuditViolation(combo.name, "dtype", f"{path} is {dt}"))
    for s in sorted(set(syncs)):
        out.append(AuditViolation(combo.name, "host-sync",
                                  f"{syncs.count(s)}x {s} inside a slot"))
    if err is not None:
        return out
    with default_dtype(torch.float64):
        dtypes64, _, _, err64 = run_combo(combo, device, policy)
    if err64 is not None:
        out.append(AuditViolation(combo.name, "float64",
                                  f"the run fails under a float64 default dtype: {err64!r}"))
    for path in sorted(set(dtypes) | set(dtypes64)):
        a, b = dtypes.get(path), dtypes64.get(path)
        if a != b and b is not None:
            show = lambda d: "/".join(sorted(map(str, d or ())))  # noqa: E731
            out.append(AuditViolation(
                combo.name, "float64",
                f"{path} is {show(b)} under a float64 default dtype, {show(a)} under float32: "
                "a tensor takes the default dtype"))
    return out


def _shape_class(combo: Combo) -> tuple:
    return (combo.policy_key, tuple(tuple(x.shape) for _, x in leaves(combo.fleet)),
            str(combo.record), repr(combo.forecaster), repr(combo.telemetry))


def audit_all(per_kind: int = AUDIT_PER_KIND, run_all: bool = False,
              device=DEFAULT_DEVICE) -> List[AuditViolation]:
    """The audit over the registry. By default one representative combo
    per (policy, shape class, record mode, forecaster, telemetry), as
    JAX's audit traces one per shape class; `run_all` runs every combo."""
    combos = iter_combos(per_kind=per_kind, device=device)
    if not run_all:
        seen, rep = set(), []
        for combo in combos:
            k = _shape_class(combo)
            if k not in seen:
                seen.add(k)
                rep.append(combo)
        combos = rep
    out: List[AuditViolation] = []
    for combo in combos:
        out.extend(audit_combo(combo, device))
    return out
