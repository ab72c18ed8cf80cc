"""Carry-over of the reference package's LM params and caches to the port.

Takes plain numpy trees only (``jax.tree.map(np.asarray, params)`` on the
reference's side), never objects of the reference package:

  * the param tree (``embed``, ``seg{i}.b{j}`` with scanned leaves stacked
    on a leading layer axis, ``final_norm``, and ``encoder`` /
    ``patch_proj`` where the config has them) -> `params_from_reference`,
    which unstacks it into the port's per-layer modules and raises on a
    missing, extra or mis-shaped leaf;
  * the cache list (one ``{b{j}: ...}`` tree per segment, scanned ones
    stacked; ``{k, v}`` for attention, ``{k, v, xk, xv}`` for
    cross-attention, the tuple ``(conv_state, state)`` for the recurrent
    kinds) -> `caches_from_reference`, one dict per layer (``{k, v}``,
    ``{k, v, xk, xv}`` or ``{conv, state}``), and back with
    `caches_to_reference`.  Both copy.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .model import RECURRENT_KINDS, Model


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _tensors(tree):
    if isinstance(tree, Mapping):
        return {k: _tensors(v) for k, v in tree.items()}
    return _tensor(tree)


def params_from_reference(model: Model, tree: Mapping) -> Model:
    """Load the reference's param tree (numpy leaves) into ``model``."""
    return model.load_tree(_tensors(tree))


def caches_from_reference(model: Model, caches: Sequence[Mapping]) -> list[dict]:
    """The reference's per-segment cache list -> one dict per layer on the
    model's device: KV and conv states in the compute dtype, recurrent
    states fp32."""
    if len(caches) != len(model.segments):
        raise ValueError(f"{len(caches)} cache segments for {len(model.segments)}")
    out: list = [None] * len(model.kinds)
    for seg, seg_cache in zip(model.segments, caches):
        for i, kind in enumerate(seg.kinds):
            c = seg_cache[f"b{i}"]
            if kind in RECURRENT_KINDS:
                c = dict(conv=c[0], state=c[1])
            for g in range(seg.n_groups):
                out[seg.first_layer + g * len(seg.kinds) + i] = {
                    name: _tensor(a[g] if seg.scanned else a).to(
                        model.device, torch.float32 if name == "state" else model.compute_dtype)
                    for name, a in c.items()
                }
    return out


def caches_to_reference(model: Model, caches: Sequence[Mapping]) -> list[dict]:
    """The port's per-layer caches -> the reference's per-segment list of
    numpy trees (scanned segments stacked; recurrent entries as tuples)."""
    out = []
    for seg in model.segments:
        seg_cache = {}
        for i, kind in enumerate(seg.kinds):
            layers = [caches[seg.first_layer + g * len(seg.kinds) + i]
                      for g in range(seg.n_groups)]
            names = tuple(model.cache_logical(kind))
            # copies: decode_step writes the port's caches in place
            leaves = [np.stack([np.array(c[name].float().cpu()) for c in layers])
                      if seg.scanned else np.array(layers[0][name].float().cpu())
                      for name in names]
            seg_cache[f"b{i}"] = tuple(leaves) if kind in RECURRENT_KINDS else dict(
                zip(names, leaves))
        out.append(seg_cache)
    return out
