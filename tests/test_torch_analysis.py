"""The port's analysis layer (`repro_torch.analysis`): lint, audit,
sanitizer and CLI.

Each lint rule fires on an inline fixture written to a temporary
directory, a `# lint: allow=` comment silences it, and the port lints
clean. The audit runs the registry clean on the CPU and catches an
injected float64 carry, an injected `.item()` inside a slot and a tensor
that takes the default dtype. The sanitizer catches an injected NaN, an
out-of-range index and an integer division by zero. The CLI exits 0 on
the port and non-zero on each kind of finding beyond its baseline.
"""
import json
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors: threads only contend with the other test workers

from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis import audit as A  # noqa: E402
from repro_torch.analysis import lint as L  # noqa: E402
from repro_torch.analysis import sanitize as S  # noqa: E402
from repro_torch.configs.fleet_scenarios import build_fleet  # noqa: E402
from repro_torch.core import CarbonIntensityPolicy  # noqa: E402
from repro_torch.core.queueing import Action  # noqa: E402

FIXTURES = {
    "host-cast": """
        import torch

        def f(x):
            y = torch.ones(3)
            return x.sum().item() + float(torch.sum(y))
        """,
    "torch-for": """
        import torch

        def f():
            out = []
            for v in torch.arange(3):
                out.append(v)
            return out
        """,
    "kernel-import": """
        import ctypes

        def f():
            return ctypes.CDLL("libkernel.so")
        """,
    "mutable-default": """
        def f(x, acc=[]):
            acc.append(x)
            return acc
        """,
    "unused-import": """
        import os
        import sys

        def f():
            return sys.argv
        """,
}


def _write(tmp_path, name, body):
    path = tmp_path / f"{name.replace('-', '_')}.py"
    path.write_text(textwrap.dedent(body))
    return path


@pytest.mark.parametrize("rule", list(FIXTURES))
def test_each_lint_rule_fires_on_its_fixture(tmp_path, rule):
    path = _write(tmp_path, rule, FIXTURES[rule])
    found = L.lint_paths([path])
    assert found and {v.rule for v in found} == {rule}, found
    assert all(v.path == str(path) and v.line > 1 for v in found)
    # a trailing allow comment on the flagged line silences it
    lines = path.read_text().splitlines()
    for v in found:
        lines[v.line - 1] += f"  # lint: allow={rule}"
    path.write_text("\n".join(lines) + "\n")
    assert L.lint_paths([path]) == []


def test_lint_scopes_and_exemptions(tmp_path):
    """Host-cast and torch-for apply inside the hot-path packages only;
    a numpy oracle is exempt from host-cast; ctypes loads are the
    business of kernels/build.py alone."""
    root = tmp_path / "repro_torch"
    for pkg in ("core", "launch", "kernels"):
        (root / pkg).mkdir(parents=True)
    body = textwrap.dedent(FIXTURES["host-cast"])
    hot = root / "core" / "step.py"
    hot.write_text(body)
    cold = root / "launch" / "tool.py"
    cold.write_text(body)
    oracle = root / "core" / "oracle.py"
    oracle.write_text("import numpy as np\n\n\ndef f(x):\n    return np.float64(x.sum().item())\n")
    build = root / "kernels" / "build.py"
    build.write_text(textwrap.dedent(FIXTURES["kernel-import"]))
    assert {v.rule for v in L.lint_file(hot, root=root)} == {"host-cast"}
    assert L.lint_file(cold, root=root) == []
    assert L.lint_file(oracle, root=root) == []
    assert L.lint_file(build, root=root) == []
    assert [v.rule for v in L.lint_file(build)] == []  # named kernels/build.py: exempt anywhere
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    assert [v.rule for v in L.lint_paths([bad])] == ["syntax"]


def test_the_port_lints_clean():
    assert L.lint_repo() == []


# ---------------------------------------------------------------- audit


def _combo(name="ci@diurnal", record="full"):
    fleet = build_fleet(["diurnal"], per_kind=2, M=A.AUDIT_M, N=A.AUDIT_N, Tc=A.AUDIT_TC,
                        device="cpu")
    return A.Combo(name, "ci", "diurnal", CarbonIntensityPolicy, None, fleet, record)


class _Float64Carry(CarbonIntensityPolicy):
    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, **kw):
        act = super().__call__(state, spec, Ce, Cc, arrivals, key, **kw)
        return Action(d=act.d, w=act.w.double())


class _ItemInSlot(CarbonIntensityPolicy):
    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, **kw):
        if state.Qe.sum().item() < 0:  # a host read each slot
            raise AssertionError
        return super().__call__(state, spec, Ce, Cc, arrivals, key, **kw)


class _DefaultDtype(CarbonIntensityPolicy):
    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, **kw):
        act = super().__call__(state, spec, Ce, Cc, arrivals, key, **kw)
        return Action(d=act.d, w=act.w + torch.zeros(act.w.shape))


def test_audit_catches_injected_faults():
    combo = _combo()
    assert A.audit_combo(combo, "cpu") == []
    found = A.audit_combo(combo, "cpu", policy=_Float64Carry())
    # slot 0 returns a float64 w, slot 1 carries a float64 Qc (and the
    # dispatch scatter then refuses it: the failed run is a finding too)
    assert any(v.check == "dtype" and "slot.action.w is torch.float64" in v.message
               for v in found), found
    assert any(v.check == "dtype" and "slot.state.Qc is torch.float64" in v.message
               for v in found), found
    assert any(v.check == "run" for v in found)
    found = A.audit_combo(combo, "cpu", policy=_ItemInSlot())
    assert [v.check for v in found] == ["host-sync"], found
    assert "8x aten::_local_scalar_dense" in found[0].message and "test_torch_analysis" not in \
        found[0].message
    found = A.audit_combo(combo, "cpu", policy=_DefaultDtype())
    assert found and {v.check for v in found} == {"float64"}, found


def test_host_syncs_count_inside_slots_only():
    """A read inside a `repro.slot` span counts, one after it does not,
    nor one inside a plain version or, where allowed, a stream flush."""
    from repro_torch.kernels import ops
    from repro_torch.telemetry.profile import phase, slot_range

    x = torch.ones(3)
    mode = A.HostSyncs(allow_flush=True)
    with A.plain_versions_unseen(mode), mode:
        for _ in slot_range(2):
            float(x.sum())
            with phase("stream_flush"):
                x.sum().item()
            ops.knapsack_dp(-torch.ones((1, 2)), torch.ones((1, 2)), torch.ones((1, 2)),
                            torch.ones(1), 4)  # its plain version reads the caps
        x.sum().item()
    assert len(mode.found) == 2 and mode.flushed == 2 and not mode.labels, mode.found
    assert all("aten::_local_scalar_dense" in f for f in mode.found)


def test_audit_registry_and_exceptions():
    """JAX's registry at its sizes: every policy (threshold and
    exact-dpp(grid=32) included) x every scenario and topology, the
    fault, telemetry, deadline and streaming combos; the streaming ones
    alone may copy to the host inside a slot."""
    combos = A.iter_combos(device="cpu")
    names = {c.name for c in combos}
    assert len(names) == len(combos) == 71
    for name in ("threshold@overload", "exact-dpp@multi-region-uk", "aware@star",
                 "guard-aware@diurnal-slack+flappy-uplink", "edd@tight-uniform",
                 "ci@diurnal-slack+stream"):
        assert name in names
    assert {c.name for c in combos if A.streams(c)} == {c.name for c in combos
                                                        if "+stream" in c.scenario} != set()
    assert A._excepted("slot.key.base") and A._excepted("slot.graph.dest")
    assert not A._excepted("slot.state.Qe")


# ------------------------------------------------------------- sanitize


class _NaN(CarbonIntensityPolicy):
    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, **kw):
        act = super().__call__(state, spec, Ce, Cc, arrivals, key, **kw)
        return Action(d=act.d, w=act.w + 0.0 * (state.Qc / state.Qc.sum() * 0.0) / 0.0)


class _OutOfRange(CarbonIntensityPolicy):
    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, **kw):
        act = super().__call__(state, spec, Ce, Cc, arrivals, key, **kw)
        idx = torch.full(act.d.shape[:-1] + (1,), act.d.shape[-1], dtype=torch.int64)
        return Action(d=act.d + act.d.gather(-1, idx), w=act.w)


class _IntDivision(CarbonIntensityPolicy):
    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, **kw):
        act = super().__call__(state, spec, Ce, Cc, arrivals, key, **kw)
        n = torch.zeros((), dtype=torch.int64)
        return Action(d=act.d, w=act.w + (torch.ones((), dtype=torch.int64) // n).float())


def test_sanitizer_catches_injected_faults():
    fleet = build_fleet(["diurnal"], per_kind=2, M=4, N=3, Tc=24, device="cpu")
    msg, res = S.sanitized_simulate_fleet(CarbonIntensityPolicy(), fleet, 6, 0, device="cpu")
    assert msg is None and res.Qe.shape == (2, 1, 4)
    msg, res = S.sanitized_simulate_fleet(_NaN(), fleet, 6, 0, device="cpu")
    assert res is None and msg.startswith("NaN produced by aten::div") and "NaN-free" in msg
    msg, _ = S.sanitized_simulate_fleet(_OutOfRange(), fleet, 6, 0, device="cpu")
    assert msg.startswith("index out of range [0, 3) in aten::gather"), msg
    msg, _ = S.sanitized_simulate_fleet(_IntDivision(), fleet, 6, 0, device="cpu")
    assert msg.startswith("integer division by zero"), msg
    # an emulation of one XLA operation is checked at its boundary: fma_f32
    # on an infinite sum is no finding (its TwoSum's inf - inf is internal),
    # inf * 0 is one
    from repro_torch.kernels import numerics

    x = torch.tensor([1.0, float("inf")])
    assert S.sanitized(numerics.fma_f32, x, 2.0, 1.0)[0] is None
    msg, _ = S.sanitized(numerics.fma_f32, x, 0.0, 1.0)
    assert msg.startswith("NaN produced by fma_f32"), msg
    assert numerics.OP_HOOK is None


# ------------------------------------------------------------------- CLI


def test_cli_exits_zero_on_the_port(capsys):
    """`python -m repro_torch.analysis --lint --audit --sanitize-smoke
    --device cpu`: every check clean."""
    assert cli.main(["--lint", "--audit", "--sanitize-smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "# lint: 0 finding(s)" in out and "# audit: 0 finding(s)" in out
    assert "# sanitize: 10 case(s) clean" in out


def test_cli_exit_codes_on_findings(tmp_path, monkeypatch, capsys):
    bad = _write(tmp_path, "mutable-default", FIXTURES["mutable-default"])
    assert cli.main([str(bad)]) == 1
    good = _write(tmp_path, "clean", "def f(x):\n    return x\n")
    assert cli.main([str(good)]) == 0
    finding = A.AuditViolation("ci@diurnal", "host-sync", "1x aten::_local_scalar_dense")
    monkeypatch.setattr(A, "audit_all", lambda **kw: [finding])
    assert cli.main(["--audit", "--device", "cpu"]) == 1
    base = tmp_path / "baseline.json"
    assert cli.main(["--audit", "--device", "cpu", "--baseline", str(base),
                     "--write-baseline"]) == 0
    assert json.loads(base.read_text())["audit"] == {"ci@diurnal::host-sync": 1}
    assert cli.main(["--audit", "--device", "cpu", "--baseline", str(base)]) == 0
    monkeypatch.setattr(S, "sanitize_smoke", lambda **kw: [("case", "NaN produced by x")])
    assert cli.main(["--sanitize-smoke", "--device", "cpu"]) == 1
    capsys.readouterr()
