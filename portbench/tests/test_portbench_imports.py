"""No module under ``portbench/`` imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and nothing the
reference loads, directly, through other ``portbench`` modules or by name
(`found.load`), imports the program."""

import ast
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


class _DropTypeChecking(ast.NodeTransformer):
    """Drops ``if TYPE_CHECKING:`` blocks, whose imports never run."""

    def visit_If(self, node):
        test = node.test
        name = test.id if isinstance(test, ast.Name) else getattr(test, "attr", None)
        return node.orelse or None if name == "TYPE_CHECKING" else self.generic_visit(node)


def _imports(path: pathlib.Path, runtime: bool = False):
    """(top-level name, or the portbench module a relative import names);
    ``runtime``: only the imports that run."""
    tree = ast.parse(path.read_text())
    if runtime:
        tree = _DropTypeChecking().visit(tree)
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


def _found_by_name(path: pathlib.Path):
    """The files ``path`` loads by name: every ``<kind>/*.py`` where it calls
    ``found.load("<kind>", ...)``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        f = getattr(node, "func", None)
        if (isinstance(node, ast.Call) and isinstance(f, ast.Attribute) and f.attr == "load"
                and isinstance(f.value, ast.Name) and f.value.id == "found" and node.args
                and isinstance(node.args[0], ast.Constant)):
            out += sorted((BENCH / node.args[0].value).glob("*.py"))
    return out


def _walk(start):
    """``(files reached, imports of the program among them)`` from ``start``:
    the imports that run, and the files loaded by name."""
    seen, todo, program = set(), list(start), []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        todo += _found_by_name(path)
        for mod in _imports(path, runtime=True):
            if mod.split(".")[0] == "repro_torch":
                program.append(f"{path.relative_to(BENCH)}: {mod}")
            if mod.split(".")[0] == "portbench":
                f = _file_of(mod)
                if f is not None:
                    todo.append(f)
    return seen, program


def test_reference_imports_nothing_of_the_program():
    refs = sorted((BENCH / "reference").glob("*.py"))
    seen, program = _walk(refs)
    assert program == []
    # the training reference finds the architecture's reference by name
    assert BENCH / "found.py" in seen and set(refs) <= seen


def test_the_walk_follows_what_is_loaded_by_name():
    """From `arch`, which loads the architecture modules by name, the walk
    reaches the decoder's module, `port` and the program: a reference that
    imported `arch` would fail the test above."""
    seen, program = _walk([BENCH / "arch.py"])
    assert {BENCH / "archs" / "decoder.py", BENCH / "port.py"} <= seen
    assert any(p.startswith("port.py: repro_torch") for p in program), program


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
