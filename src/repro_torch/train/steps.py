"""Training step factory of the port: loss + grad + clip + AdamW, with
microbatch gradient accumulation and optional gradient compression.

Value and grad come from `torch.autograd` through `Model.loss_fn`; the
step is eager, on the model's device, and syncs nothing with the host
(the metrics stay tensors).

Spans (`runtime.trace`, a no-op unless on): ``train.step`` over
``train.forward`` (`Model.loss_fn`), ``train.backward``
(`torch.autograd.grad`, where remat recomputes the scanned blocks, whose
spans nest under it) and ``train.optimizer`` (`adamw_update` and
`global_norm`); with microbatches one forward and backward each.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.layers import reshape
from ..models.model import Model
from ..optim.adamw import AdamWConfig, adamw_update, global_norm
from ..runtime import trace


def make_train_step(
    model: Model,
    schedule: Callable,
    opt_cfg: AdamWConfig,
    grad_accum: int = 1,
    cast_bf16: bool = False,
    grad_shardings=None,
):
    """Returns train_step(params, opt_state, batch) -> (params, state, metrics).

    ``params`` is a dict keyed like ``model.named_parameters()`` whose
    tensors require grad (`Model.train_params`); they and ``opt_state``
    (`optim.adamw.adamw_init`) are updated in place and returned.
    ``batch`` tensors have leading dim = global batch; with ``grad_accum >
    1`` they are split into microbatches along axis 0 and grads
    accumulated in fp32, each divided by ``grad_accum``.  Metrics:
    ``loss``, ``lr``, ``grad_norm`` (of the accumulated, uncompressed,
    unclipped grads) and ``step`` (after the update), 0-d tensors.

    ``cast_bf16``: the forward reads bf16 casts of the fp32 master params
    (one cast per step), and the grads flow back to the masters through
    the cast.  ``grad_shardings`` (a model on a mesh only; `ValueError`
    otherwise): placements keyed like ``params``; the grads (DTensors) are
    redistributed to them right after autograd, so the data-parallel
    reduction of a param's grad lands as a reduce-scatter into its shards
    instead of an all-reduce of the whole grad (the reference's
    ``with_sharding_constraint`` on the grads).
    """
    if grad_shardings is not None and model.mesh is None:
        raise ValueError("grad_shardings: the model is on no mesh and shards nothing; "
                         "pass None")

    def grad_fn(params: dict, batch: dict, t: "int | None" = None):
        with trace.span("train.forward", t=t):
            fwd = params
            if cast_bf16:
                fwd = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                       for n, p in params.items()}
            loss, aux = model.loss_fn(batch, params=fwd)
        with trace.span("train.backward", t=t):
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), aux, dict(zip(params, grads))

    def train_step(params: dict, opt_state: dict, batch: dict):
        with trace.span("train.step"):
            return _step(params, opt_state, batch)

    def _step(params: dict, opt_state: dict, batch: dict):
        with torch.enable_grad():
            if grad_accum > 1:
                # (on a mesh a batch sharded finer than grad_accum divides is
                # gathered first: `layers.reshape`)
                micro = {k: reshape(x, grad_accum, x.shape[0] // grad_accum, *x.shape[1:])
                         for k, x in batch.items()}
                # the fp32 sums start from the first microbatch's grads, so
                # on a mesh they are laid out as the grads are
                grads = None
                loss = 0.0
                for i in range(grad_accum):
                    mb_loss, _, g = grad_fn(params, {k: x[i] for k, x in micro.items()}, i)
                    g = {n: x.float() / grad_accum for n, x in g.items()}
                    grads = g if grads is None else {n: grads[n] + g[n] for n in grads}
                    loss = loss + mb_loss / grad_accum
            else:
                loss, _, grads = grad_fn(params, batch)
        if grad_shardings is not None:
            grads = {n: g.redistribute(g.device_mesh, grad_shardings[n]) for n, g in grads.items()}

        with trace.span("train.optimizer"):
            lr = schedule(opt_state["step"])
            params, opt_state = adamw_update(grads, opt_state, params, lr, opt_cfg)
            grad_norm = global_norm(grads)
        metrics = dict(loss=loss, lr=lr, grad_norm=grad_norm, step=opt_state["step"])
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params: dict, batch: dict):
        loss, _ = model.loss_fn(batch, params=params)
        return dict(loss=loss)

    return eval_step
