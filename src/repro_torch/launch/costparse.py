"""Per-device costs of a step traced on DTensors over a fake mesh.

The counterpart of the reference's ``src/repro/launch/hloparse.py``.  The
reference lowers a step with XLA, partitions it for the mesh and parses the
optimized HLO text; nothing in the port has HLO, so this module reads the
costs off the traced step itself with a `TorchDispatchMode`, `CostMode`:

  * DTensor ops are handed on (``NotImplemented``, as ``CommDebugMode``
    does), so sharding propagation runs first and the mode sees what one
    device runs: the local op on its shard, and every collective of a
    redistribute -- the explicit ones of `parallel.sharding.constrain` and
    those DTensor inserts inside an op -- as a ``_c10d_functional`` /
    ``_dtensor`` op on local tensors.  (A torch-function mode sees neither:
    torch functions are off inside ``__torch_dispatch__``.)  The ops that
    sharding propagation runs on fake tensors at global shapes are not
    counted.
  * **flops** -- ``torch.utils.flop_counter``'s formulas at the local
    shapes, with `FlopCounterMode`'s decomposition of ops it has no formula
    for.  This is the global count divided by the size of every mesh dim
    on which the op's output is ``Shard`` or ``Partial`` (a ``Replicate``
    dim repeats the whole work on every device), exact also for uneven
    shards (rank 0's, the largest).
  * **hbm_bytes** -- each op's local inputs read plus its outputs written,
    views and bookkeeping ops excluded.  An eager, unfused proxy: it reads
    higher than XLA's fused count (the reference's ``2 x result bytes`` of
    top-level HLO instructions), since every elementwise op's operands
    count.
  * **link_bytes / coll_by_kind / n_collectives** -- each collective's
    local result bytes through the reference's ring factors
    (`collective_link_bytes`), ``n`` the size of its process group
    (``default_group`` where the op names none it can resolve).
  * **peak_bytes** -- the peak of live local bytes allocated under the
    mode (arguments excluded): each new storage counts from the op that
    makes it until a weakref finalizer sees it freed.  The dry-run's
    ``temp_size_in_bytes``.
  * **n_while / trip_counts** -- the port unrolls the scanned layer groups
    as Python loops, so there is no loop to count: ``n_while`` stays 0 and
    the dry-run records ``{segment: n_groups}`` as ``trip_counts``.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

@dataclasses.dataclass
class StepCost:
    """The reference's ``HloCost`` fields, per device, plus the peak of
    live local bytes."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    link_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    n_while: int = 0
    trip_counts: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0


def collective_link_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Bytes crossing links per device for one collective, from its result
    bytes and group size ``n`` -- ``hloparse._collective_link_bytes``'s
    factors as the reference writes them."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind == "all-gather":
        return (n - 1) / n * result_bytes  # the result is the full gather
    if kind == "reduce-scatter":
        return (n - 1) * result_bytes  # the result is one shard
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    return float(result_bytes)  # collective-permute


def _collectives() -> dict:
    """op packet -> (kind, position of its group argument)."""
    import torch.distributed.tensor  # noqa: F401  (registers the _dtensor ops)

    f = torch.ops._c10d_functional
    return {
        f.all_reduce: ("all-reduce", 2),
        f.all_gather_into_tensor: ("all-gather", 2),
        f.reduce_scatter_tensor: ("reduce-scatter", 3),
        f.all_to_all_single: ("all-to-all", 3),
        torch.ops._dtensor.shard_dim_alltoall: ("all-to-all", 3),
    }


def _group_size(group, default: int) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    try:
        if isinstance(group, str):
            group = _resolve_process_group(group)
        return group.size()
    except (AttributeError, KeyError, RuntimeError, ValueError):
        return default


#: ops that move no data of their own
_FREE = {
    "aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
    "aten::new_empty_strided", "aten::detach", "aten::lift_fresh", "aten::alias",
    "_c10d_functional::wait_tensor", "_c10d_functional_autograd::wait_tensor",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fake(tensors) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in tensors)


class CostMode(TorchDispatchMode):
    """Accumulates a `StepCost` over the ops run under it (see the module
    docstring); ``mode.cost`` holds the totals.  ``device``: count only the
    ops on it (the dry-run's ``meta``), not the host tensors DTensor's
    redistribute planner computes with."""

    def __init__(self, default_group: int = 16, device: str | None = None):
        super().__init__()
        self.default_group = default_group
        self.device = None if device is None else torch.device(device)
        from torch.utils.flop_counter import flop_registry

        self.cost = StepCost()
        self._flops = flop_registry
        self._coll = _collectives()
        self._live: dict[int, int] = {}  # storage id -> bytes
        self._live_bytes = 0

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, out_tensors, in_tensors) -> None:
        inputs = {t.untyped_storage()._cdata for t in in_tensors}
        for t in out_tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self._live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar into local ops first
        packet = func._overloadpacket
        if packet not in self._flops and packet not in self._coll:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if _fake(ins) or _fake(outs):
            return out  # sharding propagation's shape inference
        if self.device is not None and not any(t.device == self.device for t in ins + outs):
            return out  # host-side bookkeeping (e.g. a redistribute's index plan)
        c = self.cost
        if packet in self._flops:
            c.flops += float(self._flops[packet](*args, **kwargs, out_val=out))
        if packet in self._coll:
            kind, gi = self._coll[packet]
            group = args[gi] if len(args) > gi else kwargs.get("group_name")
            n = _group_size(group, self.default_group)
            link = collective_link_bytes(kind, sum(_nbytes(o) for o in outs), n)
            c.link_bytes += link
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + link
            c.n_collectives += 1
        if not func.is_view and func.name() not in _FREE:
            c.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(o) for o in outs)
        self._track(outs, ins)
        return out
