"""Repo-specific AST lint for the port (stdlib ``ast`` only), the
counterpart of `repro.analysis.lint`. Rules that carry over keep the JAX
package's names:

  host-cast       ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, or
                  ``float(...)`` / ``int(...)`` / ``bool(...)`` of a torch
                  expression, inside a hot-path package: on a CUDA tensor
                  each one waits for the card (a host sync in the slot).
  torch-for       Python ``for`` iterating a ``torch.`` expression in a
                  hot-path package: one host read and one launch an
                  element (``jnp-for``'s counterpart).
  kernel-import   a ``ctypes`` library load outside ``kernels/build.py``:
                  the kernels are built and loaded there only, keyed by
                  a hash of their source (``pltpu-import``'s counterpart).
  mutable-default mutable default argument values.
  unused-import   module-level import never referenced (skipped in
                  ``__init__.py`` re-export modules; names listed in
                  ``__all__`` count as used).

No ``jax-import`` rule: `tests/test_torch_hygiene.py` already holds that
no module of the port imports jax or the JAX package. ``np-in-scan`` has
no counterpart: the port's loops are eager Python, so numpy in a loop
body is host work like any other, which ``host-cast`` and the audit's
sync count (`analysis.audit`) see, and never a value folded into a
traced program.

Suppress a finding with a trailing ``# lint: allow=<rule>`` comment (or
``# lint: allow`` for all rules on that line). Accepted findings live in
``analysis/baseline.json``; the CLI fails only on findings beyond it.

The host-cast and torch-for rules apply to the hot-path packages
(``core``, ``network``, ``forecast``, ``faults``, ``deadlines``,
``telemetry``, ``kernels``). Host-side numpy oracles (the ``oracle_*``
bounds, ``literal_algorithm1``) are recognized by their ``np.`` usage
and exempted from host-cast, as in the JAX package. Files outside
``src/repro_torch`` (the port's tests, ``chip_smoke.py``) get the
everywhere-rules only; a file linted with no root gets every rule.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, List

# Packages whose code runs inside a slot (or is a kernel's wrapper).
HOT_PACKAGES = ("core", "network", "forecast", "faults", "deadlines", "telemetry", "kernels")

RULES = (
    "host-cast",
    "torch-for",
    "kernel-import",
    "mutable-default",
    "unused-import",
)
EVERYWHERE = ("kernel-import", "mutable-default", "unused-import")

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow(?:=([\w,-]+))?")
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")
_CTYPES_LOADS = ("CDLL", "PyDLL", "LoadLibrary")


@dataclasses.dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    rule: str
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}::{self.rule}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _allowed_rules(source_line: str) -> set | None:
    """The rules suppressed on this line (empty set = all), or None."""
    m = _ALLOW_RE.search(source_line)
    if m is None:
        return None
    if m.group(1) is None:
        return set()
    return {r.strip() for r in m.group(1).split(",")}


def _attr_root(node: ast.AST) -> str | None:
    """Root name of an attribute chain: ``torch.sum`` -> ``torch``."""
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _contains_torch_ref(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.Attribute) and _attr_root(sub) == "torch"
               for sub in ast.walk(node))


def _uses_numpy(fn: ast.AST) -> bool:
    return any(isinstance(sub, ast.Attribute) and _attr_root(sub) == "np"
               for sub in ast.walk(fn))


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, active, build_module: bool):
        self.path = path
        self.lines = source.splitlines()
        self.active = set(active)
        self.build_module = build_module
        self.violations: List[LintViolation] = []
        self._fn_stack: List[ast.AST] = []

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        if rule not in self.active:
            return
        line = getattr(node, "lineno", 1)
        src = self.lines[line - 1] if line - 1 < len(self.lines) else ""
        allowed = _allowed_rules(src)
        if allowed is not None and (not allowed or rule in allowed):
            return
        self.violations.append(LintViolation(self.path, line, rule, message))

    def _in_host_fn(self) -> bool:
        """Host-side oracle heuristic: the enclosing function leans on
        numpy, so reading values on the host is its normal mode."""
        return bool(self._fn_stack) and _uses_numpy(self._fn_stack[-1])

    def _check_defaults(self, node) -> None:
        for default in list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]:
            mutable = isinstance(default, (ast.List, ast.Dict, ast.Set))
            if isinstance(default, ast.Call):
                callee = default.func
                if isinstance(callee, ast.Name) and callee.id in (
                    "list", "dict", "set", "bytearray"
                ):
                    mutable = True
            if mutable:
                self._emit(default, "mutable-default",
                           f"mutable default argument in {node.name}() is shared across calls")

    def _visit_fn(self, node) -> None:
        self._check_defaults(node)
        self._fn_stack.append(node)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (isinstance(func, ast.Name) and func.id in ("float", "int", "bool") and node.args
                and _contains_torch_ref(node.args[0]) and not self._in_host_fn()):
            self._emit(node, "host-cast",
                       f"{func.id}() of a torch expression reads it on the host (a sync on "
                       "the card)")
        if (isinstance(func, ast.Attribute) and func.attr in _HOST_METHODS and not node.args
                and not self._in_host_fn()):
            self._emit(node, "host-cast",
                       f".{func.attr}() copies a tensor to the host (a sync on the card)")
        if (isinstance(func, ast.Attribute) and func.attr in _CTYPES_LOADS
                and _attr_root(func) == "ctypes" and not self.build_module):
            self._emit(node, "kernel-import",
                       "a ctypes load outside kernels/build.py bypasses its build and "
                       "source hash (use build.load)")
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if _contains_torch_ref(node.iter):
            self._emit(node, "torch-for",
                       "Python for-loop over a torch expression reads it element by "
                       "element on the host; use a tensor op")
        self.generic_visit(node)

    def finish(self, tree: ast.Module) -> None:
        self._check_unused_imports(tree)

    def _check_unused_imports(self, tree: ast.Module) -> None:
        if "unused-import" not in self.active or Path(self.path).name == "__init__.py":
            return
        imported: dict = {}  # bound name -> node
        for node in tree.body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imported[alias.asname or alias.name.split(".")[0]] = node
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name != "*":
                        imported[alias.asname or alias.name] = node
        if not imported:
            return
        used: set = set()
        for sub in ast.walk(tree):
            if isinstance(sub, ast.Name) and not isinstance(sub.ctx, ast.Store):
                used.add(sub.id)
            elif isinstance(sub, ast.Attribute):
                root = _attr_root(sub)
                if root is not None:
                    used.add(root)
            elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                used.add(sub.value)  # __all__ entries / forward-reference annotations
        for bound, node in imported.items():
            if bound not in used:
                self._emit(node, "unused-import", f"imported name {bound!r} is never used")


def _rules_for(path: Path, root: Path | None) -> tuple:
    """Inside src/repro_torch the slot rules apply to the hot-path
    packages; anywhere else (tests, chip_smoke.py) the everywhere-rules;
    with no root, every rule."""
    if root is None:
        return RULES
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        return EVERYWHERE
    return RULES if rel.parts and rel.parts[0] in HOT_PACKAGES else EVERYWHERE


def lint_file(path: Path, root: Path | None = None) -> List[LintViolation]:
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [LintViolation(str(path), e.lineno or 1, "syntax", f"unparsable: {e.msg}")]
    build = path.name == "build.py" and path.parent.name == "kernels"
    linter = _FileLinter(str(path), source, _rules_for(path, root), build)
    linter.visit(tree)
    linter.finish(tree)
    return linter.violations


def lint_paths(paths: Iterable[Path | str], root: Path | None = None) -> List[LintViolation]:
    out: List[LintViolation] = []
    for p in paths:
        p = Path(p)
        files = sorted(f for f in p.rglob("*.py") if "__pycache__" not in f.parts) \
            if p.is_dir() else [p]
        for f in files:
            out.extend(lint_file(f, root=root))
    return out


def lint_repo(repo_root: Path | str | None = None) -> List[LintViolation]:
    """Lints src/repro_torch, the port's tests (tests/test_torch_*.py)
    and chip_smoke.py, scoped as the module docstring says. Paths are
    reported relative to the repository's root."""
    repo = Path(repo_root) if repo_root else _find_repo_root()
    src = repo / "src" / "repro_torch"
    files = [f for f in sorted(src.rglob("*.py")) if "__pycache__" not in f.parts]
    files += sorted((repo / "tests").glob("test_torch_*.py"))
    files += [f for f in (repo / "chip_smoke.py",) if f.exists()]
    out = []
    for f in files:
        for v in lint_file(f, root=src):
            out.append(dataclasses.replace(v, path=str(Path(v.path).relative_to(repo))))
    return out


def _find_repo_root() -> Path:
    here = Path(__file__).resolve()
    for parent in here.parents:
        if (parent / "pyproject.toml").exists():
            return parent
    return here.parents[3]
