"""AdamW + learning-rate schedules of the port, on dicts of tensors.

Includes the WSD (warmup-stable-decay) schedule used by MiniCPM
(arXiv:2404.06395) -- one of the assigned architectures' defining
features -- plus cosine and constant.

Functional, as the reference's: ``params``, ``grads`` and the state's
moments are nests of dicts of tensors with the same keys (a flat dict
keyed like ``named_parameters``, or the reference's tree), and the state
is ``{step, m, v[, ef]}`` with ``step`` a 0-d int32 tensor, so a
checkpoint of it carries across.  A schedule maps that step to a 0-d
fp32 tensor on its device, so a train step never syncs with the host.
`adamw_update` runs under `torch.no_grad` and writes ``params``, ``m``,
``v`` and ``ef`` in place (the reference donates them); ``grads`` are
not written.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch


def _leaves(tree):
    """The tensors of a nest of dicts, keys in sorted order (the
    reference's leaf order)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-keyed ``rest``."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def wsd_schedule(
    peak_lr: float,
    warmup_steps: int,
    stable_steps: int,
    decay_steps: int,
    final_frac: float = 0.1,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Warmup-Stable-Decay (MiniCPM §4): linear warmup, long flat stage,
    short (often exponential) decay to final_frac * peak."""

    def f(step):
        step = _f32(step)
        warm = peak_lr * step / max(1, warmup_steps)
        stable = torch.full_like(step, peak_lr)
        t = (step - warmup_steps - stable_steps) / max(1, decay_steps)
        t = torch.clamp(t, 0.0, 1.0)
        decay = peak_lr * torch.exp(torch.log(_f32(final_frac)).to(step.device) * t)
        return torch.where(step < warmup_steps, warm, torch.where(t > 0.0, decay, stable))

    return f


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = peak_lr * step / max(1, warmup_steps)
        t = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return f


def constant_schedule(lr: float):
    return lambda step: torch.full_like(_f32(step), lr)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # gradient compression for the accumulate/reduce path:
    #   none | bf16 | int8_ef (int8 with error feedback)
    compression: str = "none"


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """``{step: 0, m: 0, v: 0[, ef: 0]}``, the moments shaped (and typed)
    like ``params``, on their device."""
    zeros = lambda tree: _map(torch.zeros_like, tree)
    dev = next(_leaves(params)).device
    state = dict(step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros(params),
                 v=zeros(params))
    if cfg.compression == "int8_ef":
        state["ef"] = zeros(params)  # error-feedback residual
    return state


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))


def compress_grads(grads, state, cfg: AdamWConfig):
    """Gradient compression with error feedback.

    On a real multi-host run this wraps the cross-host reduce (the
    quantized representation is what crosses the link); here it is applied
    at the same point in the dataflow so convergence behaviour is
    identical.  ``int8_ef`` writes the state's residual in place.
    """
    if cfg.compression == "none":
        return grads, state
    if cfg.compression == "bf16":
        return _map(lambda x: x.to(torch.bfloat16).float(), grads), state
    if cfg.compression == "int8_ef":

        def q(g, e):
            g = g.float() + e
            scale = torch.clamp(torch.max(torch.abs(g)) / 127.0, min=1e-12)
            qg = torch.clamp(torch.round(g / scale), -127, 127)
            deq = qg * scale
            e.copy_(g - deq)
            return deq

        return _map(q, grads, state["ef"]), state
    raise ValueError(cfg.compression)


@torch.no_grad()
def adamw_update(grads, state: dict, params, lr: torch.Tensor, cfg: AdamWConfig):
    """One AdamW step -> (params, state), both written in place: global-
    norm clipping, bias correction, decoupled weight decay on every leaf
    (as the reference's, norms and biases included)."""
    grads, state = compress_grads(grads, state, cfg)

    if cfg.clip_norm:
        gn = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
        grads = _map(lambda g: g * scale, grads)

    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / bc1
        vhat = v / bc2
        p.copy_(p - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p))

    _map(upd, params, grads, state["m"], state["v"])
    return params, dict(state, step=step)
