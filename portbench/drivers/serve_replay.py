"""Serving driver of an MoE whose check replays the program's choice of
experts: the window is `serve`'s, the check is not.

Set-up, the window and a traced run's extra wave are `serve`'s own, run
by its code.  Then the program serves one wave again, untimed and
unprofiled: the window's wave that the seed draws for the check (as
`serve` draws it), on the window's engine, with the experts every MoE
layer chose kept (a copy a layer and routing group).  The program freed,
the plain fp32 reference (`arch.reference`, with weights it draws
itself) runs that wave's padded prompts and the tokens fed back at each
decode step with the program's choices in place of its own top k (its
gates come from its own scores), and reads:

- ``logit_gap_mean``: as `serve`'s, the mean over every served token of
  the wave of how far below the reference's best logit the served token's
  logit lies;
- ``route_miss_pct``: the share of the program's choices, over every MoE
  layer and routing group, that are not among the top k of the
  reference's own scores plus the selection bias at the same place.

Why: a top-k router whose gates are large (DeepSeek-V3's sigmoid
router, its chosen scores renormalized and scaled by 2.446, about 0.4 a
choice) turns a rounding-sized change in a score near the k-th into an
expert swapped, a step in that token's output far above rounding, which
the capacity passes on to the tokens after it at both experts and the
layers after that carry to every later token.  A check in which each
side routes by its own scores then reads mostly how often rounding
flips a choice, and a bfloat16 program reads nearly what a float8 one
does.  Replayed, the gap reads the arithmetic alone, and the choices are
judged on their own: a fault in the router (its bias, its order) shows
as choices the reference would not make, a fault in the gates, the
experts, the capacity or the attention as a gap.

``control``: the reference in float8 (`reference.served_logits`'s
``lowp``) put in the program's place: it routes by its own scores, its
choices kept; the fp32 reference replays them and reads the gap of the
token the float8 run puts first and the share of its choices missed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import arch, found, weights

serve = found.load("drivers", "serve")

TRAFFIC = serve.TRAFFIC


def run(ctx: dict) -> tuple[dict, dict]:
    """`serve`'s set-up and window, the check's wave served again with its
    choices kept, then (the program freed) the check.  `serve` hands its
    model and engine, warmed, to ``ctx["fault"]`` (the tests' hook that
    breaks the timed path): they are taken there, and a test's fault is
    passed on, so the wave served again runs the window's objects."""
    held, fault = {}, ctx.get("fault")

    def take(objs):
        held.update(objs)
        if fault:
            fault(objs)

    rec, waves = serve._window(dict(ctx, fault=take))
    t = time.perf_counter()
    wave = waves[_judged(ctx, len(waves))]
    out, routes = replayed_wave(ctx, held.pop("engine"), wave["requests"])
    held.clear()
    gc.collect()
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, wave["requests"], out, routes, control=ctx.get("control", False))
    rec["check_s"] = time.perf_counter() - t
    return rec, checks


def _judged(ctx: dict, n_waves: int) -> int:
    """The window's wave the check judges, drawn from the seed as `serve`
    draws it."""
    rng = np.random.default_rng(weights.sub_seed(ctx["seed"], "check"))
    return int(rng.integers(n_waves))


def replayed_wave(ctx: dict, engine, requests) -> tuple[np.ndarray, dict]:
    """``requests`` served once more as one wave of the window's engine
    (``generate``, greedy): ``(out (B, max_new), routes)``, ``routes``
    keyed as `reference.mla.Replay`'s: (MoE layer, 0) the prompt batch's
    choices, (MoE layer, 1) the decode steps', position-major."""
    from repro_torch.models import layers as PL

    pad = int(ctx["cell"]["traffic"]["prompt_pad"])
    calls, route = [], PL.moe_route

    def recording(p, xt, cfg):
        r = route(p, xt, cfg)
        calls.append(r.expert_idx.reshape(-1, r.expert_idx.shape[-1]).to(torch.int16))
        return r

    prompts = np.stack([serve.padded(r.prompt, pad) for r in requests])
    PL.moe_route = recording
    try:
        out = engine.generate(prompts, max(r.max_new for r in requests))
    finally:
        PL.moe_route = route
    layers = ctx["arch"].moe_layers
    steps = out.shape[1] - 1
    if len(calls) != layers * (steps + 1):
        raise RuntimeError(f"{len(calls)} routing calls for {layers} MoE layers and "
                           f"{steps} decode steps")
    routes = {}
    for j in range(layers):
        routes[(j, 0)] = calls[j]
        if steps:
            routes[(j, 1)] = torch.cat([calls[layers * (1 + t) + j] for t in range(steps)])
    return out, routes


@torch.no_grad()
def check(ctx: dict, requests, out: np.ndarray, routes: dict, control: bool = False) -> dict:
    """The replayed reference's gap below its best logit of each served
    token, and the share of the given choices its own top k misses."""
    a, dev = ctx["arch"], ctx["device"]
    pad = int(ctx["cell"]["traffic"]["prompt_pad"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W = dict(weights.draw(a, ctx["seed"], dev, torch.bfloat16, serve.tok_scale(ctx["cell"])))
    reference = arch.reference(a)
    rows = np.concatenate([np.stack([serve.padded(r.prompt, pad) for r in requests]),
                           out[:, :-1]], 1)
    toks = torch.as_tensor(rows, device=dev)
    served = [out[i, : r.max_new] for i, r in enumerate(requests)]

    def judged(given: dict, first=None) -> tuple[float, float]:
        """(mean gap, share missed) of the replayed ``given`` choices and the
        tokens ``first`` ((B, T) on the card; the served ones if None)."""
        replay = reference.Replay(given)
        ref = reference.served_logits(a, W, toks, pad, replay=replay)
        best = ref.max(-1).values
        total, n = 0.0, 0
        for i, s in enumerate(served):
            m = len(s)
            got = torch.as_tensor(np.asarray(s, np.int64), device=dev) if first is None \
                else first[i, :m]
            total += float((best[i, :m] - ref[i, :m].gather(-1, got[:, None])[:, 0]).double().sum())
            n += m
        return total / n, replay.miss_pct()

    if any(int(s.min()) < 0 or int(s.max()) >= a.vocab_size for s in served):
        return dict(logit_gap_mean=float("inf"), route_miss_pct=float("inf"), judged_tokens=0)
    gap, miss = judged(routes)
    result = dict(logit_gap_mean=gap, route_miss_pct=miss,
                  judged_tokens=sum(len(s) for s in served))
    if control:
        own = reference.Replay()
        first = reference.served_logits(a, W, toks, pad, lowp=True, replay=own).argmax(-1)
        result["control_logit_gap_mean"], result["control_route_miss_pct"] = judged(own.taken,
                                                                                     first)
    return result
