"""CLI: ``python -m repro_torch.analysis [--lint] [--audit]
[--sanitize-smoke] [--device DEV]``.

With no mode flags all three run. Positional paths switch to lint-only
mode over exactly those files or directories with every rule active.
The audit and the sanitizer run on `--device` (the card by default,
``cpu`` for the plain versions); the lint needs none.

Findings are compared against ``analysis/baseline.json``: a finding
whose ``path::rule`` (or ``combo::check``) count exceeds the baselined
count fails the run, so accepted findings never block while any new one
does. ``--write-baseline`` regenerates the file from the current tree.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

from repro_torch.analysis.lint import lint_paths, lint_repo
from repro_torch.device import DEFAULT_DEVICE

BASELINE = Path(__file__).resolve().parent / "baseline.json"


def _load_baseline(path: Path) -> dict:
    if not path.exists():
        return {"lint": {}, "audit": {}}
    return json.loads(path.read_text())


def _diff_vs_baseline(kind: str, keys, baseline: dict) -> list:
    """The findings in excess of the baselined counts."""
    counts = Counter(keys)
    allowed = Counter(baseline.get(kind, {}))
    return [(key, n, allowed.get(key, 0)) for key, n in sorted(counts.items())
            if n > allowed.get(key, 0)]


def _report(kind: str, keys: list, baseline: dict) -> bool:
    fresh = _diff_vs_baseline(kind, keys, baseline)
    for key, n, allowed in fresh:
        print(f"# NEW {kind} finding {key}: {n} > baseline {allowed}", file=sys.stderr)
    print(f"# {kind}: {len(keys)} finding(s), {len(fresh)} beyond baseline")
    return bool(fresh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("paths", nargs="*", help="lint exactly these files/dirs (all rules)")
    ap.add_argument("--lint", action="store_true")
    ap.add_argument("--audit", action="store_true")
    ap.add_argument("--run-all", action="store_true",
                    help="audit: run every registry combo, not one per shape class")
    ap.add_argument("--sanitize-smoke", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--baseline", type=Path, default=BASELINE)
    ap.add_argument("--write-baseline", action="store_true")
    args = ap.parse_args(argv)

    if args.paths:
        violations = lint_paths(args.paths)
        for v in violations:
            print(v)
        print(f"# lint: {len(violations)} violation(s) in {len(args.paths)} path(s)")
        return 1 if violations else 0

    run_all = not (args.lint or args.audit or args.sanitize_smoke)
    baseline = _load_baseline(args.baseline)
    failed = False
    new_baseline = {"lint": {}, "audit": {}}

    if args.lint or run_all:
        violations = lint_repo()
        for v in violations:
            print(v)
        keys = [v.key for v in violations]
        new_baseline["lint"] = dict(Counter(keys))
        failed |= _report("lint", keys, baseline)

    if args.audit or run_all:
        from repro_torch.analysis.audit import audit_all

        violations = audit_all(run_all=args.run_all, device=args.device)
        for v in violations:
            print(v)
        keys = [f"{v.combo}::{v.check}" for v in violations]
        new_baseline["audit"] = dict(Counter(keys))
        failed |= _report("audit", keys, baseline)

    if args.sanitize_smoke or run_all:
        from repro_torch.analysis.sanitize import sanitize_smoke

        results = sanitize_smoke(device=args.device)
        dirty = [(n, m) for n, m in results if m is not None]
        for name, msg in results:
            print(f"# sanitize {name}: {'CLEAN' if msg is None else msg}")
        if dirty:
            failed = True
            print(f"# sanitize: {len(dirty)} case(s) raised", file=sys.stderr)
        else:
            print(f"# sanitize: {len(results)} case(s) clean")

    if args.write_baseline:
        args.baseline.write_text(json.dumps(new_baseline, indent=2, sort_keys=True) + "\n")
        print(f"# baseline written to {args.baseline}")
        return 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
