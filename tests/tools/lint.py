"""Minimal stdlib linter: unused imports + syntax + whitespace hygiene.

The reference gates CI on rustfmt + clippy -D warnings
(ref: .github/workflows/path-tracer.yml:28-37). No third-party Python linter
is available offline, so this AST pass provides the equivalent warnings-are-
errors gate: every finding fails `tests/test_lint.py`.

Checks:
  - unused imports (module scope and function scope)
  - trailing whitespace / tabs in source lines
  - files that fail to parse

`__init__.py` files are exempt from the unused-import check (re-export
surface); a trailing ``# noqa`` comment exempts a single line.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path


def _imported_names(tree: ast.AST):
    """Yield (alias_node, bound_name, lineno) for every import binding."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                yield alias, bound, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                bound = alias.asname or alias.name
                yield alias, bound, node.lineno


def _used_names(tree: ast.AST) -> set[str]:
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # "a.b.c" marks "a" used via the Name node at its root; nothing
            # extra needed, but keep attribute names for "import a.b" cases.
            pass
    # Names referenced in __all__ string literals count as used.
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    for el in ast.walk(node.value):
                        if isinstance(el, ast.Constant) and isinstance(
                            el.value, str
                        ):
                            used.add(el.value)
    return used


def lint_file(path: Path) -> list[str]:
    src = path.read_text()
    problems = []
    lines = src.splitlines()
    for i, line in enumerate(lines, 1):
        if line.rstrip("\n") != line.rstrip():
            problems.append(f"{path}:{i}: trailing whitespace")
        if "\t" in line:
            problems.append(f"{path}:{i}: tab character")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: syntax error: {e.msg}"]
    if path.name != "__init__.py":
        used = _used_names(tree)
        for _alias, bound, lineno in _imported_names(tree):
            if bound in used:
                continue
            if lineno <= len(lines) and "noqa" in lines[lineno - 1]:
                continue
            problems.append(f"{path}:{lineno}: unused import '{bound}'")
    return problems


def lint_tree(root: Path) -> list[str]:
    problems = []
    skip_dirs = {"__pycache__", ".git", ".cache", "goldens", "scenes",
                 "fixtures"}
    for path in sorted(root.rglob("*.py")):
        if any(part in skip_dirs for part in path.parts):
            continue
        problems.extend(lint_file(path))
    return problems


def main() -> int:
    repo = Path(__file__).resolve().parents[2]
    problems = []
    for sub in ("path_tracer_tpu", "tests", "examples"):
        problems.extend(lint_tree(repo / sub))
    for f in ("bench.py", "bench_scaling.py", "__graft_entry__.py",
              "chip_smoke.py"):
        if (repo / f).exists():
            problems.extend(lint_file(repo / f))
    for p in problems:
        print(p)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
