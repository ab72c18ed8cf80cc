"""Source-AST lint for the port's device-discipline bug classes.

Pure path-based analysis — no imports of the linted code — so it runs on
stripped *copies* of kernel modules to prove the rules actually guard
the annotations (remove one ``# repro: host-boundary`` or one
``LAUNCHES[...] += 1`` and the lint run must flip to failing).  The
markers are the JAX package's, so one comment serves both analyzers.

Rules:

``ast-host-sync-unannotated`` (error)
    A host materializer — ``float(x)``, ``x.item()``, ``np.asarray(x)``,
    ``np.array(x)``, ``x.cpu()``, ``x.numpy()``, ``x.tolist()`` — in a
    *device-adjacent* function of a kernel module (a file carrying the
    ``# repro: kernel-module`` marker), without a ``# repro:
    host-boundary`` annotation on the call line or the line above.
    Device-adjacent = the function's source mentions ``torch.``,
    ``.to(``, ``device``, ``.cuda``, or the lazy-grid internals
    (``._raw(``, ``_LAZY_FIELDS``, ``_cell_scalar``) — places where an
    innocuous-looking ``np.asarray`` or ``.cpu()`` can be a device->host
    transfer of a whole sweep tensor and a stall of the card.  The
    annotation makes the intentional crossings (lazy-grid ``cell()``
    gathers, winner payload marshaling, host-side operand checks)
    explicit; everything else is a bug.

``ast-truthy-table`` (error)
    ``x or default`` / ``if x`` / ``not x`` / ``x if ... else`` tests on
    a value whose annotation or construction names a ``__len__``-bearing
    table type (ModelTable, TopologyTable, WorkloadTable, SuiteTable,
    the grid classes).  An *empty* table is falsy, so ``model or
    DEFAULT`` silently swaps in the default.  Use ``is None``.

``ast-launch-no-counter`` (error)
    A function that calls a hand kernel's launch entry through its ctypes
    handle (an ``extern "C" int`` function of ``kernels/csrc/*.cu``, read
    from the sources by path; the ``long`` size queries are no launches)
    but never bumps a launch counter (``LAUNCHES[...] += 1``,
    ``LAUNCH_COUNTS[...] += 1`` or ``count_launch(...)``).  An uncounted
    launch is invisible to the checks that the main path ran the hand
    kernels and not their plain versions; opt out with ``# repro:
    no-launch-count``.

``ast-host-sync-in-compile`` (error)
    A host materializer lexically inside a ``torch.compile``-wrapped
    function (decorator, ``functools.partial`` decorator, or a
    ``torch.compile(fn)`` call naming a function of an enclosing scope):
    it breaks the graph or forces a sync per call.  The port compiles
    nothing today; the rule guards the first function that it does.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from pathlib import Path

from .findings import Finding, relpath

#: Marker opting a module into the kernel-module rule set (host-sync
#: annotation discipline).  A comment so stripped copies keep it.
KERNEL_MODULE_MARK = "# repro: kernel-module"
#: Annotation acknowledging an intentional device->host materialization.
HOST_BOUNDARY_MARK = "# repro: host-boundary"
#: Annotation opting a launching function out of the launch-counter rule.
NO_COUNT_MARK = "# repro: no-launch-count"

#: Substrings that make a function "device-adjacent": its body plausibly
#: holds device tensors, so bare materializers need the annotation.
DEVICE_TOKENS = (
    "torch.",
    ".to(",
    "device",
    ".cuda",
    "._raw(",
    "_LAZY_FIELDS",
    "_cell_scalar",
)

#: ``__len__``-bearing table/grid classes truthiness is banned on.
TABLE_TYPES = (
    "ModelTable",
    "TopologyTable",
    "WorkloadTable",
    "SuiteTable",
    "ExplorationGrid",
    "VariationGrid",
    "SuiteGrid",
    "SuiteVariationGrid",
)

#: Names a launch-counter bump subscripts (``LAUNCHES["cim"] += 1``).
COUNTER_NAMES = ("LAUNCHES", "LAUNCH_COUNTS")

#: The hand kernels' sources: each ``extern "C" int`` function is a launch.
CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(')


def launch_entries(sources: "list[str] | None" = None) -> frozenset[str]:
    """The launch entries declared by ``sources`` (``.cu`` files; default
    every file of `CSRC`)."""
    if sources is None:
        sources = sorted(str(p) for p in CSRC.glob("*.cu"))
    names: set[str] = set()
    for src in sources:
        with open(src) as f:
            names.update(_ENTRY.findall(f.read()))
    return frozenset(names)


def _is_torch_compile(node: ast.AST) -> bool:
    """``torch.compile``."""
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "compile"
        and isinstance(node.value, ast.Name)
        and node.value.id == "torch"
    )


def _is_compile_decorator(node: ast.AST) -> bool:
    """``@torch.compile`` / ``@torch.compile(...)`` /
    ``@partial(torch.compile, ...)`` / ``@functools.partial(...)``."""
    if _is_torch_compile(node):
        return True
    if isinstance(node, ast.Call):
        if _is_torch_compile(node.func) and not node.args:
            return True
        f = node.func
        is_partial = (isinstance(f, ast.Attribute) and f.attr == "partial") or (
            isinstance(f, ast.Name) and f.id == "partial"
        )
        if is_partial and node.args:
            return _is_torch_compile(node.args[0])
    return False


def _materializer(call: ast.Call) -> "str | None":
    """The host-materializer kind of a call, or None."""
    f = call.func
    if isinstance(f, ast.Name) and f.id == "float" and call.args:
        return "float()"
    if isinstance(f, ast.Attribute):
        if f.attr == "item" and not call.args:
            return ".item()"
        if f.attr in ("cpu", "numpy", "tolist"):
            return f".{f.attr}()"
        if f.attr in ("asarray", "array"):
            base = f.value
            if isinstance(base, ast.Name) and base.id in ("np", "numpy"):
                return f"np.{f.attr}()"
            # `B.np.asarray` style module aliasing
            if isinstance(base, ast.Attribute) and base.attr in ("np", "numpy"):
                return f"np.{f.attr}()"
    return None


def _is_counter_bump(node: ast.AST) -> bool:
    if (
        isinstance(node, ast.AugAssign)
        and isinstance(node.op, ast.Add)
        and isinstance(node.target, ast.Subscript)
    ):
        base = node.target.value
        return (isinstance(base, ast.Name) and base.id in COUNTER_NAMES) or (
            isinstance(base, ast.Attribute) and base.attr in COUNTER_NAMES
        )
    if isinstance(node, ast.Call):
        f = node.func
        return (isinstance(f, ast.Name) and f.id == "count_launch") or (
            isinstance(f, ast.Attribute) and f.attr == "count_launch"
        )
    return False


@dataclasses.dataclass
class _Scope:
    """A lexical scope (module or function) and its immediate child
    function definitions, for resolving ``torch.compile(fn)`` by name."""

    node: ast.AST
    parent: "_Scope | None"
    defs: dict
    #: every child def, including same-named methods of sibling classes
    #: (``defs`` keeps first-wins name resolution; the walk must still
    #: visit ALL of them or later classes' methods escape the lint)
    all_defs: list

    def resolve(self, name: str) -> "ast.FunctionDef | None":
        s: "_Scope | None" = self
        while s is not None:
            if name in s.defs:
                return s.defs[name]
            s = s.parent
        return None


def _child_defs(node: ast.AST) -> "tuple[dict, list]":
    """Function defs belonging to ``node``'s scope — looking *through*
    class bodies and control-flow blocks (a method or a conditionally
    defined function is still this scope's child, not a separate one),
    but not into nested functions."""
    by_name = {}
    all_defs = []
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(n.name, n)
            all_defs.append(n)
        elif not isinstance(n, ast.Lambda):
            stack.extend(ast.iter_child_nodes(n))
    all_defs.sort(key=lambda f: f.lineno)
    return by_name, all_defs


def _walk_scopes(node: ast.AST, parent: "_Scope | None" = None):
    by_name, all_defs = _child_defs(node)
    scope = _Scope(node=node, parent=parent, defs=by_name, all_defs=all_defs)
    yield scope
    for fn in scope.all_defs:
        yield from _walk_scopes(fn, scope)


def _scope_calls(scope: _Scope):
    """Nodes belonging to ``scope`` itself (not nested functions)."""
    skip = set()
    for fn in scope.all_defs:
        for sub in ast.walk(fn):
            skip.add(id(sub))
    for sub in ast.walk(scope.node):
        if id(sub) in skip or sub is scope.node:
            continue
        yield sub


def _ann_names(annotation: "ast.AST | None") -> str:
    if annotation is None:
        return ""
    return ast.unparse(annotation)


def _tableish_type(text: str) -> bool:
    """Whether an annotation names a table type *as the value's own
    type* — ``ModelTable``, ``Optional[ModelTable]``, ``ModelTable |
    None`` — and not merely as a generic parameter of a container
    (``Mapping[str, WorkloadTable]`` is a dict; its truthiness is
    fine)."""
    t = text.strip().strip("\"'").strip()
    if t.startswith("Optional[") and t.endswith("]"):
        t = t[len("Optional["):-1]
    parts = [p.strip().strip("\"'") for p in t.split("|")]
    parts = [p for p in parts if p and p != "None"]
    return len(parts) == 1 and parts[0] in TABLE_TYPES


class _FileLint:
    def __init__(self, path: str, source: str, root: "str | None", entries: frozenset[str]):
        self.path = relpath(path, root)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.is_kernel_module = KERNEL_MODULE_MARK in source
        self.entries = entries
        self.findings: list[Finding] = []
        self.scopes = list(_walk_scopes(self.tree))
        self._own_nodes: dict[int, list] = {}

    def _own(self, scope: _Scope) -> list:
        """The nodes of ``scope`` itself (`_scope_calls`), computed once."""
        key = id(scope.node)
        if key not in self._own_nodes:
            self._own_nodes[key] = list(_scope_calls(scope))
        return self._own_nodes[key]

    # -- comment-annotation helpers -------------------------------------

    def _line(self, n: int) -> str:
        return self.lines[n - 1] if 1 <= n <= len(self.lines) else ""

    def _annotated(self, lineno: int, mark: str) -> bool:
        return mark in self._line(lineno) or mark in self._line(lineno - 1)

    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        self.findings.append(
            Finding(
                rule=rule,
                severity="error",
                path=self.path,
                line=line,
                message=message,
                context=self._line(line).strip(),
            )
        )

    # -- torch.compile discovery ----------------------------------------

    def _compiled(self) -> "dict[int, ast.FunctionDef]":
        """id(FunctionDef) -> node for every function this file wraps in
        ``torch.compile``: decorated defs, plus defs named as the first
        argument of a ``torch.compile(...)`` call in an enclosing scope."""
        wrapped: dict[int, ast.FunctionDef] = {}
        for scope in self.scopes:
            for fn in scope.all_defs:
                if any(_is_compile_decorator(d) for d in fn.decorator_list):
                    wrapped[id(fn)] = fn
            for sub in self._own(scope):
                if (
                    isinstance(sub, ast.Call)
                    and _is_torch_compile(sub.func)
                    and sub.args
                    and isinstance(sub.args[0], ast.Name)
                ):
                    target = scope.resolve(sub.args[0].id)
                    if target is not None:
                        wrapped[id(target)] = target
        return wrapped

    # -- rules -----------------------------------------------------------

    def run(self) -> list[Finding]:
        compiled = self._compiled()
        self._rule_launch_no_counter()
        self._rule_host_sync(compiled)
        self._rule_truthy_table()
        self.findings.sort(key=lambda f: (f.line, f.rule))
        return self.findings

    def _rule_launch_no_counter(self) -> None:
        for scope in self.scopes:
            fn = scope.node
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            launches = [
                sub
                for sub in self._own(scope)
                if isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in self.entries
            ]
            if not launches:
                continue
            if any(_is_counter_bump(sub) for sub in ast.walk(fn)):
                continue
            if self._annotated(fn.lineno, NO_COUNT_MARK):
                continue
            self._add(
                "ast-launch-no-counter",
                launches[0],
                f"function {fn.name!r} launches the hand kernel entry "
                f"{launches[0].func.attr!r} but never bumps a launch counter "
                f"(LAUNCHES[...] += 1 / count_launch(...)); an uncounted launch "
                f"cannot show that the main path ran the kernel "
                f"(opt out with {NO_COUNT_MARK!r})",
            )

    def _device_adjacent(self, fn: ast.FunctionDef) -> bool:
        seg = "\n".join(self.lines[fn.lineno - 1 : fn.end_lineno])
        return any(tok in seg for tok in DEVICE_TOKENS)

    def _rule_host_sync(self, compiled) -> None:
        # inside torch.compile: always an error, anywhere
        for fn in compiled.values():
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                kind = _materializer(sub)
                if kind is None or self._annotated(sub.lineno, HOST_BOUNDARY_MARK):
                    continue
                self._add(
                    "ast-host-sync-in-compile",
                    sub,
                    f"{kind} inside the torch.compile-wrapped function "
                    f"{fn.name!r}: a host sync in a compiled body breaks the "
                    f"graph or stalls the card on every call",
                )
        if not self.is_kernel_module:
            return
        seen: set[int] = set()
        for scope in self.scopes:
            fn = scope.node
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if id(fn) in compiled or not self._device_adjacent(fn):
                continue
            for sub in self._own(scope):
                if not isinstance(sub, ast.Call) or id(sub) in seen:
                    continue
                kind = _materializer(sub)
                if kind is None:
                    continue
                seen.add(id(sub))
                if self._annotated(sub.lineno, HOST_BOUNDARY_MARK):
                    continue
                self._add(
                    "ast-host-sync-unannotated",
                    sub,
                    f"{kind} in device-adjacent function {fn.name!r} of a "
                    f"kernel module: if the operand is a device tensor this "
                    f"is a hidden device->host transfer — annotate the "
                    f"intentional boundary with {HOST_BOUNDARY_MARK!r} or "
                    f"keep the value on the device",
                )

    def _rule_truthy_table(self) -> None:
        for scope in self.scopes:
            tableish = self._tableish_names(scope)
            if not tableish:
                continue
            for sub in self._own(scope):
                name = self._truthiness_target(sub)
                if name is not None and name in tableish:
                    self._add(
                        "ast-truthy-table",
                        sub,
                        f"truthiness test on {name!r}, a __len__-bearing "
                        f"table ({tableish[name]}): an empty table is "
                        f"falsy, so `or`-defaults/`if` silently replace "
                        f"it — use `is None`",
                    )

    def _tableish_names(self, scope: _Scope) -> dict[str, str]:
        """Names in ``scope`` whose annotation or construction names a
        table type."""
        node = scope.node
        out: dict[str, str] = {}
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = list(node.args.args) + list(node.args.kwonlyargs)
            if node.args.vararg:
                args.append(node.args.vararg)
            for a in args:
                ann = _ann_names(a.annotation)
                if _tableish_type(ann):
                    out[a.arg] = ann
        for sub in self._own(scope):
            targets: list[ast.AST] = []
            value = None
            if isinstance(sub, ast.Assign):
                targets, value = sub.targets, sub.value
            elif isinstance(sub, ast.AnnAssign) and sub.target is not None:
                ann = _ann_names(sub.annotation)
                if _tableish_type(ann) and isinstance(sub.target, ast.Name):
                    out[sub.target.id] = ann
                targets, value = [sub.target], sub.value
            if value is None or not isinstance(value, ast.Call):
                continue
            ctor = value.func
            ctor_name = ""
            if isinstance(ctor, ast.Name):
                ctor_name = ctor.id
            elif isinstance(ctor, ast.Attribute):
                # ModelTable.from_models(...), TopologyTable.from_...
                base = ctor.value
                if isinstance(base, ast.Name):
                    ctor_name = base.id
            if ctor_name in TABLE_TYPES:
                for t in targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = ctor_name
        return out

    @staticmethod
    def _truthiness_target(node: ast.AST) -> "str | None":
        """The bare name whose truthiness ``node`` tests, if any."""
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or):
            first = node.values[0]
            if isinstance(first, ast.Name):
                return first.id
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            if isinstance(node.operand, ast.Name):
                return node.operand.id
        if isinstance(node, (ast.If, ast.IfExp)):
            if isinstance(node.test, ast.Name):
                return node.test.id
        if isinstance(node, ast.While) and isinstance(node.test, ast.Name):
            return node.test.id
        return None


def lint_file(
    path: str, root: "str | None" = None, entries: "frozenset[str] | None" = None
) -> list[Finding]:
    with open(path) as f:
        source = f.read()
    try:
        return _FileLint(path, source, root, launch_entries() if entries is None else entries).run()
    except SyntaxError as e:
        return [
            Finding(
                rule="ast-syntax-error",
                severity="error",
                path=relpath(path, root),
                line=e.lineno or 0,
                message=f"cannot parse: {e.msg}",
                context="",
            )
        ]


def lint_paths(paths: "list[str]", root: "str | None" = None) -> list[Finding]:
    """Lint ``paths`` (files or directory trees of ``.py`` files)."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                files.extend(
                    os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py")
                )
        else:
            files.append(p)
    entries = launch_entries()
    out: list[Finding] = []
    for f in sorted(set(files)):
        out.extend(lint_file(f, root, entries))
    return out
