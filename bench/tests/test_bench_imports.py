"""Nothing the benchmark runs imports the JAX stack or the JAX package
(``repro``), and the plain reference imports nothing of the program.
Top-level names are compared whole: ``repro_torch`` is not ``repro``.
Imports are followed through the benchmark's own modules and the
program's, inside functions too."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

import harness

BENCH = harness.BENCH
SRC = harness.ROOT / "src"
LOCAL = {p.stem for p in BENCH.glob("*.py")} | {"reference"}


def _imports(path: Path) -> set:
    """Absolute module names imported anywhere in ``path``."""
    tree = ast.parse(path.read_text(), str(path))
    pkg = path.parent
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = _package_of(pkg, node.level)
                mod = ".".join(filter(None, [base, node.module]))
                out.add(mod)
                out.update(f"{mod}.{a.name}" for a in node.names)
            else:
                out.add(node.module)
                out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def _package_of(pkg: Path, level: int) -> str:
    for _ in range(level - 1):
        pkg = pkg.parent
    for root in (SRC, BENCH):
        if root in pkg.parents or pkg == root:
            return ".".join(pkg.relative_to(root).parts)
    raise AssertionError(pkg)


def _file_of(name: str):
    parts = name.split(".")
    for root in ((SRC,) if parts[0] == "repro_torch" else
                 (BENCH,) if parts[0] in LOCAL else ()):
        base = root.joinpath(*parts)
        for cand in (base.with_suffix(".py"), base / "__init__.py"):
            if cand.exists():
                return cand
    return None


def closure(entry: Path) -> dict:
    """file -> the module names it imports, over every file reached."""
    seen, todo = {}, [entry]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen[f] = _imports(f)
        for name in seen[f]:
            g = _file_of(name)
            if g is not None and g not in seen:
                todo.append(g)
    return seen


ENTRIES = [BENCH / "run.py", BENCH / "calibrate.py",
           *sorted((BENCH / "drivers").glob("*.py")),
           *sorted((BENCH / "metrics").glob("*.py"))]


@pytest.mark.parametrize("entry", ENTRIES, ids=lambda p: p.name)
def test_nothing_run_imports_jax_or_the_jax_package(entry):
    bad = {f"{f.relative_to(harness.ROOT)}: {n}"
           for f, names in closure(entry).items() for n in names
           if n.split(".")[0] in harness.FORBIDDEN}
    assert not bad, sorted(bad)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    for name in ("repro_torch_like", "reprox.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]


@pytest.mark.parametrize("driver", sorted((BENCH / "drivers").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_walk_reaches_the_program(driver):
    assert any(SRC / "repro_torch" in f.parents for f in closure(driver))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    reached = closure(path)
    assert all(f.is_relative_to(BENCH / "reference") for f in reached)
    tops = {n.split(".")[0] for names in reached.values() for n in names}
    assert tops <= {"__future__", "math", "numpy", "torch", "reference"}
