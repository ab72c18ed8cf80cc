"""Plain float32 reference of the training step: mean next-token cross
entropy, gradients by autograd, clipping by the global norm, and AdamW
with bias correction and decoupled weight decay on every leaf, under the
warmup-stable-decay schedule (MiniCPM, arXiv:2404.06395 §4).

The forward is the configuration's architecture's plain reference,
``reference/<arch>.py`` (its ``hidden`` and ``unembed``), found by name:
no module of the architecture is loaded.  Leaves are the stacked kinds of
`portbench.weights`, as float32 tensors; the per-leaf readings split them
back into one leaf per layer, the unit the program keeps, but for the
architecture's global kinds, which the caller names.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from .. import found

if TYPE_CHECKING:
    from ..arch import Arch


def wsd_lr(step: int, peak: float, warmup: int, stable: int, decay: int,
           final_frac: float = 0.1) -> float:
    if step < warmup:
        return peak * step / max(1, warmup)
    t = min(max((step - warmup - stable) / max(1, decay), 0.0), 1.0)
    return peak * final_frac ** t if t > 0 else peak


def loss_and_grads(a: Arch, W: dict, tokens: torch.Tensor, labels: torch.Tensor,
                   lowp: bool = False) -> float:
    """Mean cross entropy over every label of the batch; the gradients are
    left in each leaf's ``.grad`` (summed one sequence at a time, so a
    full-size batch fits)."""
    if a.is_moe:
        raise NotImplementedError("the reference trains dense decoders only")
    plain = found.load("reference", a.arch)
    n = labels.numel()
    total = 0.0
    for r in range(tokens.shape[0]):
        x = plain.hidden(a, W, tokens[r:r + 1], lowp=lowp, checkpoint=True)
        nll = 0.0
        for c in range(0, x.shape[1], 512):  # the logits a chunk at a time
            def chunk(xc, lc):
                logits = plain.unembed(a, W, xc, lowp)
                return (torch.logsumexp(logits, -1)
                        - logits.gather(-1, lc[..., None])[..., 0]).sum()
            nll = nll + torch.utils.checkpoint.checkpoint(
                chunk, x[:, c:c + 512], labels[r:r + 1, c:c + 512], use_reentrant=False)
        (nll / n).backward()
        total += float(nll.detach())
    return total / n


class AdamW:
    def __init__(self, W: dict, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0):
        self.b1, self.b2, self.eps, self.wd, self.clip = b1, b2, eps, weight_decay, clip_norm
        self.m = {k: torch.zeros_like(v) for k, v in W.items()}
        self.v = {k: torch.zeros_like(v) for k, v in W.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, W: dict, lr: float) -> dict:
        """One step; returns the clipped gradients the moments took in."""
        g = {k: w.grad for k, w in W.items()}
        norm = math.sqrt(sum(float(x.double().pow(2).sum()) for x in g.values()))
        scale = min(1.0, self.clip / max(norm, 1e-12)) if self.clip else 1.0
        g = {k: x * scale for k, x in g.items()}
        self.step += 1
        bc1 = 1 - self.b1 ** self.step
        bc2 = 1 - self.b2 ** self.step
        for k, w in W.items():
            self.m[k].mul_(self.b1).add_(g[k], alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g[k], g[k], value=1 - self.b2)
            upd = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + self.eps)
            w.sub_(lr * (upd + self.wd * w))
            w.grad = None
        return g


def kind_norms(kind: str, t: torch.Tensor, global_kinds) -> dict:
    """L2 norms of one stacked kind's leaves, keyed ``kind`` (one of
    ``global_kinds``, the architecture's ``GLOBAL``) or ``kind.<index>``
    (one leaf a layer), as host floats."""
    t = t.detach().double()
    if kind in global_kinds:
        return {kind: float(t.norm())}
    return {f"{kind}.{i}": v for i, v in enumerate(t.flatten(1).norm(dim=1).tolist())}


def leaf_norms(tree: dict, global_kinds) -> dict:
    """`kind_norms` of every kind of ``tree``, in its order (the draw's)."""
    out = {}
    for kind, t in tree.items():
        out.update(kind_norms(kind, t, global_kinds))
    return out
