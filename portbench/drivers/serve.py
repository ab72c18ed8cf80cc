"""Serving driver: a closed loop of waves on the port's `ServeEngine.serve`.

Set-up builds the port's model in bfloat16 (as ``launch/serve.py llm``
does), loads the benchmark's weights, and warms the cell's two shapes: one
prefill of the padded prompt batch and three decode steps at ``max_seq``.
The window then serves whole waves (`traffic.wave`) until ``--seconds``
have passed; it closes when the last wave returns.

Spans (host clock) wrap the program's calls into its layers: each
``Model.decode_step`` call's start is when the engine has read back the
token before it, and ``generate``'s return when it has read back the
wave's last.  The window runs alike in a plain and a traced run: nothing
synchronizes there, so the gaps between tokens are the ones a user sees.
A traced run then serves one more wave, of the window's sizes, after the
window has closed: the profiler covers its decode steps 8-15, and every
other call into the model is a span synchronized on both sides
(``prefill``, and each ``decode_step`` with the requests still live in it
and, for an MoE, the experts its live tokens route to in each layer).

The check (after the window, with the program freed): the plain fp32
reference of the configuration's architecture (`arch.reference`), with
weights it draws itself, runs the padded prompts and the
tokens fed back at each decode step, and reads how far below its best
logit each served token's logit lies.  A dense model is judged on a
sample of requests from the seed, the longest among them; an MoE on one
whole wave from the seed, since a routing group is the batch and the
capacity couples its rows (there the tokens a finished slot kept
decoding, which serve drops, are fed back as the program made them; only
served tokens are judged).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import arch, port, profiling, traffic, weights

TRAFFIC = ("closed_waves",)  # the traffic kinds this driver takes
CHUNK = 64  # attention's query and key chunks, as launch/serve.py builds the model
ROWS_AT_ONCE = 2  # requests the reference runs together (a 2,176-token fp32 row's scores are 0.7 GB)
PROFILE_STEPS = (8, 16)  # decode steps of the extra wave under the profiler; the others are spans


def run(ctx: dict) -> tuple[dict, dict]:
    """Set-up, the window, then (the program freed) the check."""
    rec, waves = _window(ctx)
    gc.collect()
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(ctx, waves, control=ctx.get("control", False))
    rec["check_s"] = time.perf_counter() - t
    return rec, checks


def _window(ctx: dict) -> tuple[dict, list]:
    a, cell, seed, dev = ctx["arch"], ctx["cell"], ctx["seed"], ctx["device"]
    tr = cell["traffic"]
    n, pad, max_seq = int(tr["clients"]), int(tr["prompt_pad"]), int(tr["max_seq"])
    trace = ctx["trace"]
    from repro_torch.serve.engine import Request, ServeEngine

    model = port.build(a, dev, torch.bfloat16, chunk=CHUNK)
    port.load(model, a, seed, torch.bfloat16, tok_scale(cell))
    engine = ServeEngine(model, batch=n, max_seq=max_seq, temperature=0.0, device=dev)

    # phase: "warm" (set-up), "window" (timed), "profile" (a traced run's extra wave)
    st = dict(wave=None, phase="warm", spans=[], prefill_ms=[], routes=None,
              prof=profiling.Window() if trace else None)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    decode_step, prefill, generate = model.decode_step, model.prefill, engine.generate

    def timed_decode(caches, tok, pos):
        w = st["wave"]
        w["decode_t"].append(time.perf_counter())  # the token before this step is on the host
        t = len(w["decode_t"]) - 1
        if st["phase"] != "profile":
            return decode_step(caches, tok, pos)
        if PROFILE_STEPS[0] <= t < PROFILE_STEPS[1]:
            return profiled_decode(caches, tok, pos, t)
        st["routes"] = []
        sync()
        t0 = time.perf_counter()
        out = decode_step(caches, tok, pos)
        sync()
        st["spans"].append(dict(t=t, ms=1e3 * (time.perf_counter() - t0), routes=st["routes"]))
        st["routes"] = None
        return out

    def profiled_decode(caches, tok, pos, t):
        if t == PROFILE_STEPS[0]:
            st["prof"].start()
        out = decode_step(caches, tok, pos)
        st["prof"].steps += 1
        if t == PROFILE_STEPS[1] - 1:
            st["prof"].stop()
        return out

    def timed_prefill(batch):
        if st["phase"] != "profile":
            return prefill(batch)
        sync()
        t0 = time.perf_counter()
        out = prefill(batch)
        sync()
        st["prefill_ms"].append(1e3 * (time.perf_counter() - t0))
        return out

    def recorded_generate(prompts, max_new, extra_batch=None):
        out = generate(prompts, max_new, extra_batch)
        st["wave"]["t_return"] = time.perf_counter()
        st["wave"]["out"] = np.array(out)
        return out

    model.decode_step, model.prefill, engine.generate = timed_decode, timed_prefill, recorded_generate
    restore_route = _record_routes(st) if trace and a.is_moe else (lambda: None)
    try:
        return _serve_waves(ctx, st, model, engine, Request, sync)
    finally:
        restore_route()


def _serve_waves(ctx, st, model, engine, Request, sync):
    a, seed, trace = ctx["arch"], ctx["seed"], ctx["trace"]
    tr = ctx["cell"]["traffic"]
    n, pad, dev = int(tr["clients"]), int(tr["prompt_pad"]), ctx["device"]

    def serve(reqs, index):
        st["wave"] = dict(index=index, requests=reqs, decode_t=[], t_return=None, out=None)
        done = engine.serve([Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new)
                             for r in reqs], prompt_pad=pad)
        by_uid = {r.uid: [int(x) for x in r.out_tokens] for r in done}
        st["wave"]["served"] = [by_uid[r.uid] for r in reqs]
        return st["wave"]

    # warm-up: the wave's prefill shape and a few decode steps at max_seq
    warm = [traffic.Request(r.uid, r.prompt, min(4, r.max_new))
            for r in traffic.wave(tr, a.vocab_size, seed, -1)]
    serve(warm, -1)
    sync()
    if ctx.get("fault"):
        ctx["fault"](dict(model=model, engine=engine))

    st["phase"] = "window"
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    waves = []
    while not waves or time.perf_counter() - t0 < ctx["seconds"]:
        waves.append(serve(traffic.wave(tr, a.vocab_size, seed, len(waves)), len(waves)))
    window_s = time.perf_counter() - t0
    if trace:  # one more wave of the window's sizes, after the window (17 steps at least)
        st["phase"] = "profile"
        m = min(PROFILE_STEPS[1] + 1, int(tr["max_seq"]) - pad)
        extra = serve([traffic.Request(r.uid, r.prompt, max(r.max_new, m))
                       for r in traffic.wave(tr, a.vocab_size, seed, -1)], -1)
        st["prof"].stop()
    st["phase"] = "done"

    gaps, tokens = [], 0
    for w in waves:
        times = w["decode_t"] + [w["t_return"]]
        for r, served in zip(w["requests"], w["served"]):
            if len(served) != r.max_new:
                raise RuntimeError(f"request {r.uid}: {len(served)} tokens for max_new {r.max_new}")
            tokens += r.max_new
            gaps += [1e3 * (times[j + 1] - times[j]) for j in range(r.max_new - 1)]
    rec = dict(arch=a, setup_s=setup_s, window_s=window_s, tokens_out=tokens, token_gaps_ms=gaps,
               attempted=sum(len(w["requests"]) for w in waves), failed=0,
               batch=n, prompt_pad=pad,
               waves=[dict(prompt_len=[len(r.prompt) for r in w["requests"]],
                           max_new=[r.max_new for r in w["requests"]],
                           decode_steps=len(w["decode_t"])) for w in waves])
    if trace:
        rec.update(prefill_ms=st["prefill_ms"], decode_spans=_live_spans(st["spans"], extra))
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if trace:
        rec["profile"] = st["prof"].reduce()
    return rec, waves


def _live_spans(spans: list[dict], wave: dict) -> list[dict]:
    """Each synchronized decode step with what it had to do: its live
    requests (step t feeds a request's token t, so it is live while t <
    max_new - 1), the positions they attend on average (their own prompt,
    unpadded, and t + 1 tokens), and for an MoE the routed experts their
    tokens reach, on average over the MoE layers."""
    reqs, out = wave["requests"], []
    for s in spans:
        live = [i for i, r in enumerate(reqs) if s["t"] < r.max_new - 1]
        if not live:
            continue
        span = dict(ms=s["ms"], live=len(live),
                    attended=float(np.mean([len(reqs[i].prompt) + s["t"] + 1 for i in live])))
        if s["routes"]:
            rows = torch.as_tensor(live)
            span["experts_hit"] = float(np.mean(
                [len(torch.unique(x.reshape(-1, x.shape[-1]).cpu()[rows])) for x in s["routes"]]))
        out.append(span)
    return out


def tok_scale(cell: dict) -> float:
    return float(cell.get("weights", {}).get("tok_scale", 1.0))


def _record_routes(st: dict):
    """Keep each MoE layer's chosen experts while ``st["routes"]`` is a list
    (a span of the extra wave): one copy of a few KB a layer."""
    from repro_torch.models import layers as PL

    route = PL.moe_route

    def recording(p, xt, cfg):
        r = route(p, xt, cfg)
        if st["routes"] is not None:
            st["routes"].append(r.expert_idx.detach().clone())
        return r

    PL.moe_route = recording

    def restore():
        PL.moe_route = route

    return restore


def padded(prompt: np.ndarray, pad: int) -> np.ndarray:
    """The engine's input row for a prompt: left-padded with id 0 to ``pad``."""
    row = np.zeros(pad, np.int64)
    row[pad - len(prompt):] = prompt
    return row


def judged_rows(ctx: dict, waves: list[dict]):
    """``(tokens (R, T), served per row)`` the reference runs: the padded
    prompts then the tokens fed back at each decode step."""
    a, cell = ctx["arch"], ctx["cell"]
    pad = int(cell["traffic"]["prompt_pad"])
    rng = np.random.default_rng(weights.sub_seed(ctx["seed"], "check"))
    if a.is_moe:  # one whole wave: its batch is one routing group a step
        w = waves[int(rng.integers(len(waves)))]
        fed = w["out"][:, :-1]
        rows = np.concatenate([np.stack([padded(r.prompt, pad) for r in w["requests"]]), fed], 1)
        return [(rows, w["served"])]
    reqs = [(r, s) for w in waves for r, s in zip(w["requests"], w["served"])]
    longest = max(range(len(reqs)), key=lambda i: len(reqs[i][0].prompt) + reqs[i][0].max_new)
    k = min(int(cell["check"]["sample"]), len(reqs))
    rest = [i for i in rng.permutation(len(reqs)) if i != longest][: k - 1]
    pick = [reqs[i] for i in [longest, *rest]]
    out = []
    for c in range(0, len(pick), ROWS_AT_ONCE):
        part = pick[c:c + ROWS_AT_ONCE]
        t = max(pad + len(s) - 1 for _, s in part)
        rows = np.zeros((len(part), t), np.int64)
        for i, (r, s) in enumerate(part):
            rows[i, :pad] = padded(r.prompt, pad)
            rows[i, pad:pad + len(s) - 1] = s[:-1]
        out.append((rows, [s for _, s in part]))
    return out


@torch.no_grad()
def check(ctx: dict, waves: list[dict], control: bool = False) -> dict:
    """The widest gap between the reference's best logit and a served
    token's (``control``: also the gap of the token a float8 reference puts
    first, at the same positions)."""
    a, dev = ctx["arch"], ctx["device"]
    pad = int(ctx["cell"]["traffic"]["prompt_pad"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W = dict(weights.draw(a, ctx["seed"], dev, torch.bfloat16, tok_scale(ctx["cell"])))
    reference = arch.reference(a)
    widest, widest_ctl, judged, total, total_ctl = 0.0, 0.0, 0, 0.0, 0.0
    for rows, served in judged_rows(ctx, waves):
        toks = torch.as_tensor(rows, device=dev)
        ref = reference.served_logits(a, W, toks, pad)
        best = ref.max(-1).values
        ctl_first = (reference.served_logits(a, W, toks, pad, lowp=True).argmax(-1)
                     if control else None)
        for i, s in enumerate(served):
            m = len(s)
            got = torch.as_tensor(s, device=dev)
            if bool(((got < 0) | (got >= a.vocab_size)).any()):
                return dict(logit_gap=float("inf"), judged_tokens=judged)
            gap = best[i, :m] - ref[i, :m].gather(-1, got[:, None])[:, 0]
            widest = max(widest, float(gap.max()))
            total += float(gap.double().sum())
            judged += m
            if control:
                cg = best[i, :m] - ref[i, :m].gather(-1, ctl_first[i, :m, None])[:, 0]
                widest_ctl = max(widest_ctl, float(cg.max()))
                total_ctl += float(cg.double().sum())
        del ref, best
    out = dict(logit_gap=widest, logit_gap_mean=total / judged, judged_tokens=judged)
    if control:
        out.update(control_logit_gap=widest_ctl, control_logit_gap_mean=total_ctl / judged)
    return out
