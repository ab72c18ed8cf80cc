"""Carry-over of the reference package's LM params and caches to the port.

Takes plain numpy trees only (``jax.tree.map(np.asarray, params)`` on the
reference's side), never objects of the reference package:

  * the param tree (``embed``, ``seg{i}.b{j}`` with scanned leaves stacked
    on a leading layer axis, ``final_norm``) -> `params_from_reference`,
    which unstacks it into the port's per-layer modules and raises on a
    missing, extra or mis-shaped leaf;
  * the cache list (one ``{b{j}: {k, v}}`` tree per segment, scanned ones
    stacked) -> `caches_from_reference`, one ``{k, v}`` dict per layer.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .model import Model


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
    """The reference's per-segment cache list -> one ``{k, v}`` dict per
    layer on the model's device, in its compute dtype."""
    if len(caches) != len(model.segments):
        raise ValueError(f"{len(caches)} cache segments for {len(model.segments)}")
    out: list = [None] * len(model.kinds)
    for seg, seg_cache in zip(model.segments, caches):
        for i in range(len(seg.kinds)):
            for g in range(seg.n_groups):
                c = seg_cache[f"b{i}"]
                out[seg.first_layer + g * len(seg.kinds) + i] = {
                    name: _tensor(c[name][g] if seg.scanned else c[name]).to(
                        model.device, model.compute_dtype)
                    for name in ("k", "v")
                }
    return out
