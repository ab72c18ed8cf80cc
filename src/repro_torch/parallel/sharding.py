"""Logical-axis sharding rules with divisibility fallback, on DTensor.

Parameters and activations are annotated with *logical* axis names; the
rule table maps each logical axis to an ordered list of preferred mesh
axes.  A mesh axis is used only if it (a) exists in the mesh, (b) is not
already taken by an earlier tensor dim, and (c) divides the dim size --
several assigned configs have head counts / vocab sizes that do NOT divide
the 16-way model axis (minicpm 36 heads, qwen 20 heads, whisper 51865
vocab, ...); the fallback keeps those dims replicated (or lets a
later-preference axis take over).

The rules and `spec_for` are the reference's (``repro.parallel.sharding``)
and return its form: one entry per tensor dim, ``None``, a mesh-axis name
or a tuple of names sharded jointly, trailing ``None``s dropped.
`placements_for` turns a spec into DTensor placements on a `DeviceMesh`
(``Shard(d)`` on every mesh dim the spec names, ``Replicate()`` on the
rest), and `constrain` -- the reference's ``with_sharding_constraint`` --
redistributes a DTensor to them.

A mesh is a `DeviceMesh` (axis sizes by ``mesh_dim_names``) or, where
only sizes are read (the rules and `spec_for`), a mapping ``{axis:
size}``.

On a multi-pod ``(pod, data, model)`` mesh the DTensors live on its
`compute_mesh`, with ``pod`` and ``data`` flattened into one dim: the rules
only ever shard over the two together (a ``(pod, data)`` tuple, the
reference's data axes), so a joint collective is one group of ``pod *
data`` ranks, as in the reference's partitioned HLO, and DTensor plans its
redistributes on a 2-D mesh (on the 3-D one they take it minutes per
cell).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence


def default_rules(pc) -> dict[str, list]:
    """Keys are logical axis names; values are preference-ordered mesh-axis
    groups (a tuple entry means "shard jointly over these")."""
    data = tuple(pc.all_data_axes)
    model = pc.model_axis
    fsdp = [data] if pc.fsdp else []
    return {
        # params
        "vocab": [model, data],          # embedding rows: TP first
        "embed": fsdp,                   # d_model dim of params: FSDP
        "heads": [model],                # attention q heads
        "kv_heads": [model],
        "head_dim": [],
        "qkv": [model],                  # fused head*dim output dim
        "mlp": [model, data],            # ffn hidden
        "experts": [model],              # MoE expert dim (EP)
        "expert_mlp": [],
        "ssm_inner": [model, data],
        "ssm_state": [],
        "ssm_heads": [model],
        "lru": [model, data],
        "conv": [],
        "layers": [],                    # stacked-scan leading dim
        # activations
        "batch": [data],
        "seq": [],
        "act_seq_shard": [model],        # sequence parallelism points
        "act_embed": [],
        "act_heads": [model],
        "act_mlp": [model],
        "act_experts": [model],
        "kv_seq": [model],               # decode KV sharded over model
        "pod_batch": [data],
    }


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a `DeviceMesh` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def rules_for_model(cfg, pc, mesh) -> dict[str, list]:
    """Model-aware rule table: keeps weight and activation sharding
    *consistent* for attention (if heads don't divide the model axis both
    the fused-QKV weight dim and the activation head dim replicate, instead
    of paying a reshard every layer), and enables decode-KV sequence
    sharding exactly when head sharding is impossible."""
    rules = default_rules(pc)
    model = pc.model_axis
    msize = mesh_axes(mesh).get(model, 1)

    heads_ok = cfg.n_heads % msize == 0
    kv_ok = cfg.n_kv_heads % msize == 0
    if not heads_ok:
        # attention runs data-parallel; don't TP the qkv/o weights either
        rules["qkv"] = [tuple(pc.all_data_axes)] if pc.fsdp else []
        rules["act_heads"] = []
    if not kv_ok:
        rules["kv_heads"] = []
        # decode KV memory instead shards the sequence over the model axis
        rules["kv_seq"] = [model] if pc.seq_shard_kv else []
        # ... and q heads must NOT shard over model either: a head-sharded q
        # against seq-sharded KV forces a per-layer KV all-gather
        rules["act_heads"] = []
        rules["qkv"] = [tuple(pc.all_data_axes)] if pc.fsdp else []
    else:
        rules["kv_seq"] = []
    return rules


def spec_for(mesh, shape: Sequence[int], logical: Sequence[str | None],
             rules: Mapping[str, list]) -> tuple:
    """The reference's PartitionSpec for ``shape`` from logical axis names,
    as a tuple (one entry per dim, trailing ``None``s dropped)."""
    assert len(shape) == len(logical), (shape, logical)
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    out: list = []
    for dim, name in zip(shape, logical):
        chosen = None
        if name:
            for cand in rules.get(name, []):
                cand_axes = (cand,) if isinstance(cand, str) else tuple(cand)
                if not all(a in sizes for a in cand_axes):
                    continue
                if any(a in used for a in cand_axes):
                    continue
                size = math.prod(sizes[a] for a in cand_axes)
                if size <= 1 or dim % size != 0:
                    continue
                chosen = cand_axes if len(cand_axes) > 1 else cand_axes[0]
                used.update(cand_axes)
                break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


#: the flattened ``(pod, data)`` dim of a multi-pod mesh's `compute_mesh`
POD_DATA = "pod_data"


def compute_mesh(mesh):
    """The `DeviceMesh` the DTensors of ``mesh`` live on: ``mesh`` itself,
    or for a ``(pod, data, model)`` mesh its 2-D ``(pod_data, model)``
    view (`launch.mesh.make_mesh` flattens the two)."""
    if "pod" not in mesh.mesh_dim_names:
        return mesh
    return mesh[POD_DATA, "model"]


def placements_for(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``compute_mesh(mesh)``: ``Shard(d)``
    on each mesh dim that tensor dim ``d``'s entry names, ``Replicate()``
    elsewhere.  A tuple entry shards one tensor dim over several mesh dims,
    which must be named in mesh order (DTensor splits the outer mesh dim
    first, as a PartitionSpec's tuple does); ``("pod", "data")`` is the one
    flattened dim of a multi-pod mesh, and either of the two alone there
    raises `ValueError`."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(compute_mesh(mesh).mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if POD_DATA in names:
            if tuple(a for a in axes if a in ("pod", "data")) not in ((), ("pod", "data")):
                raise ValueError(f"spec entry {entry}: pod and data shard only together")
            axes = tuple(POD_DATA if a == "pod" else a for a in axes if a != "data")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(mesh, shape: Sequence[int], spec: Sequence) -> tuple[int, ...]:
    """The shard of ``shape`` one device holds under ``spec`` (every named
    axis divides its dim, as `spec_for` guarantees)."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[d] //= sizes[a]
    return tuple(out)


def sharded_zeros(mesh, shape: Sequence[int], spec: Sequence, dtype, device):
    """A DTensor of global ``shape`` placed by ``spec``, its local shard
    zeros on ``device`` (on ``meta``: nothing allocated)."""
    import torch
    from torch.distributed.tensor import DTensor

    shape = tuple(int(s) for s in shape)
    local = torch.zeros(local_shape(mesh, shape, spec), dtype=dtype, device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, compute_mesh(mesh), placements_for(mesh, spec),
                              run_check=False, shape=torch.Size(shape), stride=stride)


def constrain(x, mesh, logical: Sequence[str | None], rules):
    """``with_sharding_constraint`` via logical names: redistribute the
    DTensor ``x`` to its spec's placements (no-op without a mesh)."""
    if mesh is None:
        return x
    spec = spec_for(mesh, x.shape, logical, rules)
    return x.redistribute(compute_mesh(mesh), placements_for(mesh, spec))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_specs(mesh, params_logical, shapes, rules):
    """A tree (dicts / lists) of logical-axis tuples + the same tree of
    shapes -> the tree of specs."""
    if _is_logical(params_logical):
        return spec_for(mesh, shapes, params_logical, rules)
    if isinstance(params_logical, Mapping):
        return {k: tree_specs(mesh, v, shapes[k], rules) for k, v in params_logical.items()}
    return [tree_specs(mesh, v, s, rules) for v, s in zip(params_logical, shapes)]


def _register_rules() -> None:
    """Sharding rules DTensor lacks on the path of a train step.

    * ``aten.softplus_backward``: DTensor has a rule for ``softplus`` but
      none for its backward, so the recurrent blocks' train step
      (``F.softplus`` in `models.ssm`) could not be traced on a mesh.  The
      op is pointwise in ``grad_output`` and ``self`` (``beta`` and
      ``threshold`` are scalars), so it takes the strategies DTensor gives
      ``softplus``: both operands replicated, or both sharded on the same
      dim.
    * ``aten.constant_pad_nd``: torch 2.11's rule offers one ``Replicate``
      placement whatever the mesh, which its redistribute cannot reach on
      a mesh of two or more dims (the recurrent blocks' causal conv pads
      its input).  Padding is local on every dim it does not pad, so the
      op takes ``Replicate``, or ``Shard(d)`` on an unpadded dim ``d``.

    ``Partial`` is offered by neither: ``softplus_backward`` is not linear
    in ``self``, and a pad with a non-zero value is not linear either."""
    try:
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import register_sharding
    except ImportError as e:
        raise ImportError(
            "parallel.sharding needs torch.distributed.tensor.experimental."
            "register_sharding to give aten.softplus_backward and "
            "aten.constant_pad_nd their sharding rules") from e
    import torch

    aten = torch.ops.aten

    @register_sharding(aten.softplus_backward.default)
    def _softplus_backward(grad_output, self, beta, threshold):
        out = [([Replicate()], [Replicate(), Replicate(), None, None])]
        for d in range(self.ndim):
            out.append(([Shard(d)], [Shard(d), Shard(d), None, None]))
        return out

    @register_sharding(aten.constant_pad_nd.default)
    def _constant_pad_nd(self, pad, value=0):
        padded = {self.ndim - 1 - i // 2 for i, n in enumerate(pad) if n}
        out = [([Replicate()], [Replicate(), None, None])]
        for d in range(self.ndim):
            if d not in padded:
                out.append(([Shard(d)], [Shard(d), None, None]))
        return out


_register_rules()
