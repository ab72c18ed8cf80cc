"""Unified kernel registry: one launch counter, one catalogue of kernels.

The counterpart of the JAX package's registry.  Eager torch compiles
nothing, so where that registry counts jit *traces* this one counts
*launches of the hand-written CUDA kernels* (``csrc/*.cu``):

  * `LAUNCH_COUNTS` — the single process-wide Counter.  A kernel wrapper
    bumps it where it launches its kernel, and nowhere else (a call that
    runs the plain torch version on CPU tensors is no launch).  The
    kernel modules expose their keys as `CounterView`\\ s
    (``aig_sim.LAUNCHES``, ``cim_logic.LAUNCHES``), so
    ``LAUNCHES["cim"] += 1`` and ``LAUNCH_COUNTS["cim"]`` are one number.
  * `register_counter(name, module)` — declares which module owns a
    counter key; `launch_counts(module=...)` filters the snapshot to it.
  * `register_kernel(name, module, build, x64=, launches=)` — hands the
    graph lint (`repro_torch.analysis.graph_lint`) a lazy
    representative-shape builder: a callable taking a ``device`` and
    returning a `KernelExample` (the function the production path runs
    plus small operands already on that device).  ``launches`` names the
    hand-kernel counters a run of the kernel must bump on the devices in
    ``launch_devices`` (CUDA by default: on the CPU the plain versions
    run by design).

The registry imports nothing from the kernel modules (they import *it*),
and `kernel_specs()` imports the default kernel modules lazily so plain
``import repro_torch.analysis`` stays cheap.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import importlib.util
from collections.abc import MutableMapping
from typing import Any, Callable, Mapping, Sequence

#: The single per-process launch counter of the hand kernels.
LAUNCH_COUNTS: "collections.Counter[str]" = collections.Counter()

#: counter key -> owning module (dotted name), filled by `register_counter`.
KERNEL_OWNERS: dict[str, str] = {}

#: Modules whose import registers the real kernels (each module calls
#: `register_counter` / `register_kernel` at import time).  This is also
#: the list `graph_lint` walks by default.
DEFAULT_KERNEL_MODULES: tuple[str, ...] = (
    "repro_torch.core.batch",
    "repro_torch.kernels.aig_sim",
    "repro_torch.kernels.cim_logic",
    "repro_torch.launch.system",
)


def count_launch(kernel: str) -> None:
    """Bump ``kernel``'s launch counter (the same as
    ``LAUNCH_COUNTS[kernel] += 1``)."""
    LAUNCH_COUNTS[kernel] += 1


def launch_counts(module: str | None = None) -> dict[str, int]:
    """Snapshot of the launch counters: every key with ``module=None``,
    else only the keys ``module`` owns."""
    if module is None:
        return dict(LAUNCH_COUNTS)
    return {k: v for k, v in LAUNCH_COUNTS.items() if KERNEL_OWNERS.get(k) == module}


class CounterView(MutableMapping):
    """A module's launch counters as a dict: reads, writes (``view[k] +=
    1``, ``view[k] = 0``) and ``dict(view)`` go to `LAUNCH_COUNTS` under
    the same keys.  The key set is fixed; deleting is refused."""

    def __init__(self, keys: "tuple[str, ...]"):
        self._keys = tuple(keys)

    def __getitem__(self, key):
        if key not in self._keys:
            raise KeyError(key)
        return LAUNCH_COUNTS[key]

    def __setitem__(self, key, value) -> None:
        if key not in self._keys:
            raise KeyError(key)
        LAUNCH_COUNTS[key] = value

    def __delitem__(self, key) -> None:
        raise TypeError("launch counters cannot be deleted")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr(dict(self))


@dataclasses.dataclass(frozen=True)
class KernelExample:
    """One runnable kernel instance: the callable the production path
    runs, positional operands at representative shapes on the device the
    builder was given, and keyword arguments (the reference's statics)."""

    fn: Callable[..., Any]
    args: tuple
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A registered kernel: its name, owning module, and the builder the
    graph lint runs it through.

    ``x64``: the kernel's floats are float64 end to end (the dtype-drift
    rule applies); integer-only kernels register with ``x64=False``.
    ``launches``: hand-kernel counters one run must bump on a device whose
    type is in ``launch_devices``.
    """

    name: str
    module: str
    build: Callable[[Any], KernelExample]
    x64: bool = True
    launches: tuple[str, ...] = ()
    launch_devices: tuple[str, ...] = ("cuda",)


_REGISTRY: "dict[str, KernelSpec]" = {}


def register_counter(name: str, module: str) -> None:
    """Declare ``module`` as the owner of counter key ``name``.
    Idempotent for the same owner; two modules claiming one key is a
    bug."""
    owner = KERNEL_OWNERS.get(name)
    if owner is not None and owner != module:
        raise ValueError(f"launch counter {name!r} already registered to {owner}")
    KERNEL_OWNERS[name] = module


def register_kernel(
    name: str,
    module: str,
    build: Callable[[Any], KernelExample],
    x64: bool = True,
    launches: Sequence[str] = (),
    launch_devices: Sequence[str] = ("cuda",),
) -> None:
    """Register a kernel for the graph lint (and declare its name).

    ``build(device)`` is called only when the lint runs and must return a
    `KernelExample` whose operands lie on ``device``; the lint runs
    ``fn(*args, **kwargs)`` once, eagerly, and records what it
    dispatches."""
    register_counter(name, module)
    prev = _REGISTRY.get(name)
    if prev is not None and prev.module != module:
        raise ValueError(f"kernel {name!r} already registered by {prev.module}")
    _REGISTRY[name] = KernelSpec(
        name=name, module=module, build=build, x64=x64,
        launches=tuple(launches), launch_devices=tuple(launch_devices),
    )


def load_kernel_module(spec: str):
    """Import a kernel module by dotted name or by ``.py`` file path
    (file paths let lint fixtures register seeded-violation kernels
    without living on the import path)."""
    if spec.endswith(".py"):
        mod_spec = importlib.util.spec_from_file_location(
            "_lint_fixture_" + spec.replace("/", "_").replace(".", "_"), spec
        )
        if mod_spec is None or mod_spec.loader is None:
            raise ImportError(f"cannot load kernel module from {spec}")
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(spec)


def kernel_specs(modules: Sequence[str] | None = None) -> list[KernelSpec]:
    """The registered kernels of ``modules`` (default: the real kernel
    modules), importing each module first so its registrations run.

    File-path entries register under the module name they pass to
    `register_kernel`; re-executing a file replaces its entries with
    fresh `KernelSpec` objects, so identity comparison recovers the
    file's registrations on repeat loads too."""
    mods = DEFAULT_KERNEL_MODULES if modules is None else tuple(modules)
    wanted: set[str] = set()
    for m in mods:
        before = dict(_REGISTRY)
        load_kernel_module(m)
        if m.endswith(".py"):
            wanted.update(s.module for k, s in _REGISTRY.items() if before.get(k) is not s)
        else:
            wanted.add(m)
    return sorted(
        (s for s in _REGISTRY.values() if s.module in wanted),
        key=lambda s: (s.module, s.name),
    )
