"""Training driver: the port's train step as ``launch/train.py`` builds it.

Set-up builds the model with float32 masters (bfloat16 compute,
``remat="block"``, chunks of 256), loads the benchmark's weights, and
makes the step with `make_train_step`, `adamw_init` and the WSD schedule
of the workload file.  That one object then takes the first three
steps, through the window's own call and feed (`traffic.train_batch`,
each step's rows new): they are the warm-up and the steps the check
follows.  After the first the gradient the optimizer took in is read from
its first moment (``m = (1 - b1) g``), after the third each leaf's change
from the initial draw (drawn again).  The window then runs steps until
``--seconds`` have passed; each step ends with the launcher's read-back of
the loss.  A traced run profiles one more step after the window.

The check (after the window, with the program freed): the plain fp32
reference (`reference.train`) takes the same three steps from its own draw
of the weights and compares each step's loss, the first gradient by
leaf, and the change by leaf after the three.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from .. import arch, port, profiling, traffic, weights
from ..reference import train as ref

TRAFFIC = ("synthetic_lm",)  # the traffic kinds this driver takes
CHUNK = 256  # attention's query and key chunks, as launch/train.py builds the model
FOLLOWED = 3  # steps the reference follows


def run(ctx: dict) -> tuple[dict, dict]:
    rec, prog = _window(ctx)
    gc.collect()
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(ctx, prog)
    rec["check_s"] = time.perf_counter() - t
    return rec, checks


def schedule_args(cell: dict) -> tuple:
    s = cell["program"]["schedule"]
    return float(s["peak_lr"]), int(s["warmup"]), int(s["stable"]), int(s["decay"])


def _window(ctx: dict):
    a, cell, seed, dev = ctx["arch"], ctx["cell"], ctx["seed"], ctx["device"]
    tr, prog = cell["traffic"], cell["program"]
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, wsd_schedule
    from repro_torch.train.steps import make_train_step

    model = port.build(a, dev, torch.float32, chunk=CHUNK)
    port.load(model, a, seed, torch.float32)
    params = model.train_params()
    opt_cfg = AdamWConfig(**prog["adamw"])
    state = dict(params=params, opt=adamw_init(params, opt_cfg))
    step_fn = make_train_step(model, wsd_schedule(*schedule_args(cell)), opt_cfg)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if ctx.get("fault"):
        step_fn = ctx["fault"](dict(model=model, step_fn=step_fn)) or step_fn

    def feed(step: int) -> dict:
        raw = traffic.train_batch(tr, a.vocab_size, seed, step)
        return dict(tokens=torch.as_tensor(raw[:, :-1].astype(np.int64), device=dev),
                    labels=torch.as_tensor(raw[:, 1:].astype(np.int64), device=dev),
                    mask=torch.ones(raw[:, 1:].shape, dtype=torch.float32, device=dev))

    def step(i: int) -> float:
        state["params"], state["opt"], metrics = step_fn(state["params"], state["opt"], feed(i))
        return float(metrics["loss"])  # the launcher's read-back ends the step

    param_name = arch.module(a).param_name
    names = {key: param_name(a, kind, i) for key, kind, i in weights.leaves(a)}
    losses = [step(0)]
    m = state["opt"]["m"]
    grad = {k: float(m[n].norm()) / (1 - opt_cfg.b1) for k, n in names.items()}
    losses += [step(i) for i in range(1, FOLLOWED)]
    change = {}
    with torch.no_grad():
        for kind, t0 in weights.draw(a, seed, dev, torch.float32):
            for key, k2, i in weights.leaves(a):
                if k2 == kind:
                    p = model.get_parameter(names[key])
                    change[key] = float((p - (t0 if i is None else t0[i])).norm())
    sync()

    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    n = 0
    while not n or time.perf_counter() - t0 < ctx["seconds"]:
        step(FOLLOWED + n)
        n += 1
    window_s = time.perf_counter() - t0
    prof = None
    if ctx["trace"]:  # one more step, after the window, under the profiler
        prof = profiling.Window()
        prof.start()
        step(FOLLOWED + n)
        prof.steps = 1
        prof.stop()

    b, s = int(tr["batch"]), int(tr["seq"])
    rec = dict(arch=a, setup_s=setup_s, window_s=window_s, steps=n, batch=b, seq=s,
               tokens_trained=n * b * s, attempted=n, failed=0,
               memory_peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    if prof:
        rec["profile"] = prof.reduce()
    return rec, dict(losses=losses, grad=grad, change=change)


def gap(got: dict, want: dict, keys) -> float:
    """Worst leaf: the gap between two norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys)


def check(ctx: dict, prog: dict, lowp: bool = False) -> dict:
    """The reference's three steps (``lowp``: in float8, the control) against
    the program's readings."""
    r = follow(ctx, lowp)
    med = statistics.median(r["grad"].values())
    moved = [k for k, g in r["grad"].items() if g >= 1e-3 * med]
    return dict(
        loss_gap=max(abs(p - q) / abs(q) for p, q in zip(prog["losses"], r["losses"])),
        grad_gap=gap(prog["grad"], r["grad"], list(r["grad"])),
        update_gap=gap(prog["change"], r["change"], moved),
        leaves_left_out=len(r["grad"]) - len(moved),
    )


def follow(ctx: dict, lowp: bool = False) -> dict:
    """The reference's readings of the first three steps."""
    a, cell, seed, dev = ctx["arch"], ctx["cell"], ctx["seed"], ctx["device"]
    tr = cell["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W = {k: t.requires_grad_(True) for k, t in weights.draw(a, seed, dev, torch.float32)}
    glob = arch.module(a).GLOBAL
    opt = ref.AdamW(W, **cell["program"]["adamw"])
    out = dict(losses=[])
    for i in range(FOLLOWED):
        raw = torch.as_tensor(traffic.train_batch(tr, a.vocab_size, seed, i).astype(np.int64),
                              device=dev)
        out["losses"].append(ref.loss_and_grads(a, W, raw[:, :-1], raw[:, 1:], lowp))
        grads = opt.update(W, ref.wsd_lr(i, *schedule_args(cell)))
        if i == 0:
            out["grad"] = ref.leaf_norms(grads, glob)
        del grads
    out["change"] = {}
    with torch.no_grad():
        for kind, t0 in weights.draw(a, seed, dev, torch.float32):
            out["change"].update(ref.kind_norms(kind, W[kind] - t0, glob))
    return out
