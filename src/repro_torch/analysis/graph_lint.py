"""Run every registered kernel once and lint the aten ops it dispatched.

The counterpart of the JAX package's jaxpr layer.  Every kernel
registered through `repro_torch.analysis.registry` carries a
representative-shape builder.  This layer calls the builder on a device,
then runs ``fn(*args, **kwargs)`` once under a ``TorchDispatchMode`` that
records every aten op with the dtypes and devices of its tensor inputs
and outputs.  This is *eager execution*, not abstract tracing: the ops
really run on the device (on ``cuda`` the hand kernels launch), so the
record is exactly what the production call dispatches at these shapes.
The rules:

``graph-dtype-drift`` (error)
    In an ``x64`` kernel, an op whose floating output is not float64.
    The back half's parity with the scalar path (``rtol=1e-12``) rests on
    float64 end to end; one stray ``.float()`` halves precision for the
    whole downstream dataflow.

``graph-host-sync`` (error)
    ``aten._local_scalar_dense`` (what ``.item()``, ``float(t)``,
    ``int(t)`` and ``bool(t)`` dispatch), ``aten.is_nonzero``, or any op
    that moves data between devices (a ``.cpu()``, an upload, an index
    held on another device) inside the kernel's body.  On a card each is
    a stall of the host on the stream.

``graph-device-escape`` (error)
    A factory op (no tensor inputs) whose output is not on the device of
    the example's operands (a ``torch.ones`` that forgot ``device=``): on
    a card it is a CPU tensor in the middle of device work, and the next
    op that meets it copies or raises.  Ops on a tensor that a transfer
    already moved off are that transfer's, which `graph-host-sync`
    reports.

``graph-launch-missing`` (error)
    The kernel declares hand-kernel launch counters for the device it ran
    on (on ``cuda`` by default), and the run did not bump one of them:
    the wrapper fell back to its plain version, or lost its
    ``LAUNCHES[...] += 1``.  On the CPU the plain versions run by design,
    so the rule is inactive there unless a kernel asks for it.

``graph-run-error`` (error)
    The builder or the run raised: the example is broken and the kernel
    is unverifiable.

Not carried over from the jaxpr layer, because eager torch has no
counterpart of what they guard:

  * ``jaxpr-baked-const`` guards XLA's compile-cache key against large
    closed-over constants; eager torch has no compile cache to key.
  * ``jaxpr-static-unhashable`` guards jit's static arguments, which key
    that cache and must hash; eager torch has no static arguments.
  * ``jaxpr-donate-cpu`` guards buffer donation on a backend that ignores
    it; eager torch has no donation (the port's in-place updates are
    explicit ``out=`` / ``copy_`` calls).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..device import resolve_device
from .findings import Finding
from .registry import LAUNCH_COUNTS, KernelSpec, kernel_specs

_aten = torch.ops.aten
#: Ops that read a device value on the host.
SYNC_OPS = frozenset({_aten._local_scalar_dense.default, _aten.is_nonzero.default})


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index
    )


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class KernelRun:
    """What one run of a registered kernel dispatched."""

    spec: KernelSpec
    device: torch.device
    ops: "collections.Counter[str]" = dataclasses.field(default_factory=collections.Counter)
    syncs: list[str] = dataclasses.field(default_factory=list)
    #: (op, shape of its output) of each op that moved data between devices
    transfers: list[tuple[str, tuple[int, ...]]] = dataclasses.field(default_factory=list)
    escapes: list[str] = dataclasses.field(default_factory=list)
    drift: list[str] = dataclasses.field(default_factory=list)
    launches: dict[str, int] = dataclasses.field(default_factory=dict)
    output: Any = None
    error: "tuple[str, str] | None" = None  # (stage, message)


class _Recorder(TorchDispatchMode):
    def __init__(self, run: KernelRun):
        super().__init__()
        self.run = run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        run = self.run
        name = str(func)
        run.ops[name] += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        # 0-d CPU inputs are wrapped Python scalars, read on the host
        in_devs = {t.device for t in ins if not (t.ndim == 0 and t.device.type == "cpu")}
        devs = in_devs | {t.device for t in outs}
        if func in SYNC_OPS:
            run.syncs.append(name)
        elif len(devs) > 1:
            run.syncs.append(f"{name} across {' and '.join(sorted(str(d) for d in devs))}")
            run.transfers.append((name, tuple(outs[0].shape) if outs else ()))
        elif not in_devs:
            # a factory: ops on a tensor already moved off are the move's
            for t in outs:
                if not _on(t, run.device):
                    run.escapes.append(f"{name} -> {t.device}")
                    break
        if run.spec.x64:
            for t in outs:
                if t.is_floating_point() and t.dtype != torch.float64:
                    run.drift.append(f"{name} -> {str(t.dtype).removeprefix('torch.')}")
                    break
        return out


def run_kernel(spec: KernelSpec, device: "str | torch.device") -> KernelRun:
    """Build ``spec``'s example on ``device`` and run it once, recording
    every aten op it dispatches and the launch counters it bumps.  Outputs
    are held to the device of the example's operands (``device`` where
    the example has none)."""
    dev = torch.device(device)
    run = KernelRun(spec=spec, device=dev)
    try:
        example = spec.build(dev)
    except Exception as e:  # the registry builder itself broke
        run.error = ("build", f"{type(e).__name__}: {e}")
        return run
    # the example's operands name the device its outputs must stay on
    operands = _tensors((example.args, dict(example.kwargs)))
    if operands:
        run.device = operands[0].device
    before = {k: LAUNCH_COUNTS[k] for k in spec.launches}
    try:
        with _Recorder(run):
            run.output = example.fn(*example.args, **dict(example.kwargs))
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    except Exception as e:
        run.error = ("run", f"{type(e).__name__}: {e}")
    run.launches = {k: LAUNCH_COUNTS[k] - before[k] for k in spec.launches}
    return run


def _finding(spec: KernelSpec, rule: str, detail: str, message: str) -> Finding:
    return Finding(
        rule=rule,
        severity="error",
        path=spec.module,
        line=0,
        message=f"kernel {spec.name!r}: {message}",
        context=f"{spec.name}: {detail}",
    )


def findings_of(run: KernelRun) -> list[Finding]:
    """The findings of one `KernelRun` (one per rule and detail)."""
    spec = run.spec
    out: list[Finding] = []
    if run.error is not None:
        stage, msg = run.error
        return [_finding(spec, "graph-run-error", stage, f"the {stage} raised {msg}")]
    for detail in dict.fromkeys(run.drift):
        out.append(_finding(
            spec, "graph-dtype-drift", detail,
            f"{detail} inside an x64 kernel — the back half is float64 end "
            f"to end; a narrower float silently loses precision downstream"))
    for detail in dict.fromkeys(run.syncs):
        out.append(_finding(
            spec, "graph-host-sync", detail,
            f"{detail} inside the kernel's body — a host read or a copy "
            f"between devices stalls the host on the card's stream"))
    for detail in dict.fromkeys(run.escapes):
        out.append(_finding(
            spec, "graph-device-escape", detail,
            f"{detail}: an output off the operands' device {run.device}"))
    if run.device.type in spec.launch_devices:
        for counter, delta in run.launches.items():
            if delta <= 0:
                out.append(_finding(
                    spec, "graph-launch-missing", counter,
                    f"running on {run.device} did not bump LAUNCH_COUNTS"
                    f"[{counter!r}] — the hand kernel did not launch (the "
                    f"plain version ran, or the wrapper lost its counter)"))
    return out


def same_outputs(a, b, rtol: float = 1e-12) -> bool:
    """Whether two runs' outputs agree (on any devices): the same tree of
    tensors, integers and booleans bit for bit, floats to ``rtol``."""
    fa, ta = tree_flatten(a)
    fb, tb = tree_flatten(b)
    if ta != tb:
        return False
    for x, y in zip(fa, fb):
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
            continue
        y = y.to(x.device)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            if not torch.allclose(x, y, rtol=rtol, atol=0.0, equal_nan=True):
                return False
        elif not torch.equal(x, y):
            return False
    return True


def lint_kernels(
    modules: "Sequence[str] | None" = None, device: "str | torch.device | None" = None
) -> list[Finding]:
    """Lint every kernel registered by ``modules`` (default: the real
    kernel modules) on ``device`` (default ``cuda``; raises without a
    card)."""
    dev = resolve_device(device)
    out: list[Finding] = []
    for spec in kernel_specs(modules):
        out.extend(findings_of(run_kernel(spec, dev)))
    return out
