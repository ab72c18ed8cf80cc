"""No module under ``portbench/`` imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and nothing the
reference imports, directly or through other ``portbench`` modules,
imports the program."""

import ast
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: pathlib.Path):
    """(top-level name, or the portbench module a relative import names)."""
    tree = ast.parse(path.read_text())
    pkg = path.relative_to(BENCH.parent).with_suffix("").parts[:-1]
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[: len(pkg) - node.level + 1]
                mod = ".".join(base + ((node.module,) if node.module else ()))
                out.add(mod)
                out |= {f"{mod}.{a.name}" for a in node.names}
            else:
                out.add(node.module)
                out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {sorted(tops & FORBIDDEN)}"


def _file_of(mod: str):
    p = BENCH.parent / pathlib.Path(*mod.split("."))
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def test_reference_imports_nothing_of_the_program():
    seen, todo = set(), sorted((BENCH / "reference").glob("*.py"))
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for mod in _imports(path):
            assert mod.split(".")[0] != "repro_torch", f"{path} imports {mod}"
            if mod.split(".")[0] == "portbench":
                f = _file_of(mod)
                if f is not None:
                    todo.append(f)
    assert BENCH / "weights.py" in seen and BENCH / "arch.py" in seen


def test_a_run_loads_no_jax():
    """The harness and a tiny run of each driver, in a fresh process."""
    code = (
        "import sys, time, torch\n"
        "from portbench import harness\n"
        "from portbench.tests import tiny\n"
        "for cell in (tiny.SERVE, tiny.TRAIN):\n"
        "    harness.run_cell(cell, tiny.MOE if cell is tiny.SERVE else tiny.DENSE, 1, 0.0,\n"
        "                     False, torch.device('cpu'), time.perf_counter())\n"
        "print(harness.forbidden_modules())\n")
    root = BENCH.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env={"PYTHONPATH": f"{root}:{root / 'src'}", "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
