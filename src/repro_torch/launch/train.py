"""Training launcher of the port (the end-to-end training loop).

``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is asked for.  Presets: ``full`` (the published
config), ``smoke`` (the reduced CPU config) and ``100m`` (about 100M
params, the family's block pattern kept).  Params are fp32 masters, the
compute bf16, each scan group under `torch.utils.checkpoint`
(``remat="block"``).

One process trains on one device.  Under a process group -- one the
caller set up, or the one ``__main__`` starts from ``torchrun``'s
variables (NCCL, one card a rank; gloo with ``--device cpu``) -- every
rank trains on the ``(world / M, M)`` `launch.mesh.make_host_mesh` of
``--model-parallel M``, as the reference trains on its host mesh: the
params are DTensors placed by the logical-axis rules
(`parallel.sharding.rules_for_model`), and every rank draws the one-host
batch of (seed, step) and keeps its data shard, so the run computes the
losses of the one-device run of the same argv.  Without a group
``--model-parallel`` above 1 is refused with a `ValueError`.

Fault tolerance exercised here, as in the reference's launcher:
  * atomic keep-3 checkpoints (``--ckpt-dir``, every ``--ckpt-every``
    steps and at the end) in the reference's layout, ``dict(p=params,
    o=opt_state)`` with scanned leaves stacked, + resume from the state's
    ``step`` (``--resume``).  The snapshot is a device-side copy handed
    to `ckpt.manager.CheckpointManager` with ``defer_snapshot=True``:
    its writer thread moves it to the host while training goes on;
  * SIGTERM/SIGINT -> a final checkpoint before exit (preemption
    handling);
  * deterministic data (`data.pipeline`): every batch is a pure function
    of (seed, step), so a resumed run sees the batches the first would
    have;
  * step-time straggler monitor (EMA; logs steps exceeding 3x it).

``--trace-out PATH`` switches the port's tracer (`runtime.trace`) on for
the run and writes one Chrome-trace JSON there at exit (rank 0 only): the
train step's spans (``train.step``, ``.forward``, ``.backward``,
``.optimizer``, the blocks and the MoE inside them) on the host and (on a
card) their device intervals, and the counters, with ``ts`` in
microseconds of CLOCK_REALTIME, the clock of a ``torch.profiler`` trace
(the first `trace.LIMIT` spans; it prints how many it dropped past them).

Examples::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --preset 100m --model-parallel 2

    python -m repro_torch.launch.train --device cpu --preset smoke --steps 8
    python -m repro_torch.launch.train --preset 100m --ckpt-dir /tmp/ck --ckpt-every 2
    python -m repro_torch.launch.train --preset 100m --ckpt-dir /tmp/ck --resume
    python -m repro_torch.launch.train --arch minicpm-2b --preset full --steps 6
    python -m repro_torch.launch.train --device cpu --steps 2 --trace-out /tmp/train_trace.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import signal
import sys
import threading
import time


def build_model_config(arch: str, preset: str):
    from ..configs import get_config, smoke_config

    if preset == "full":
        return get_config(arch)
    if preset == "smoke":
        return smoke_config(arch)
    if preset == "100m":
        base = get_config(arch)
        return dataclasses.replace(
            base,
            n_layers=max(4, min(8, base.n_layers)),
            d_model=768,
            n_heads=12,
            n_kv_heads=12 if base.n_kv_heads == base.n_heads else 4,
            head_dim=64,
            d_ff=2048,
            vocab_size=32_000,
            vocab_pad_multiple=128,
            n_experts=base.n_experts and 16,
            moe_d_ff=base.moe_d_ff and 512,
            d_inner=1536 if base.family == "ssm" else 0,
            lru_width=768 if base.lru_width else 0,
            enc_seq=256 if base.enc_seq else 0,
        )
    raise ValueError(preset)


def _whole(t):
    """A DTensor gathered whole on every rank (a collective); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _snapshot(model, params: dict, opt_state: dict) -> dict:
    """``dict(p=params, o=opt_state)`` in the reference's layout, as fresh
    device tensors (the train step writes the live ones in place); on a
    mesh each leaf gathered whole, on every rank."""
    from ..models.layers import tree_leaves
    from ..models.model import _nest

    o = {k: model.to_tree(v) if isinstance(v, dict) else v.clone() for k, v in opt_state.items()}
    tree = dict(p=model.to_tree(params), o=o)
    if model.mesh is None:
        return tree
    return _nest({path: _whole(t) for path, t in tree_leaves(tree)})


def shard_batch(batch: dict, model, logical: dict) -> dict:
    """The one-host batch as DTensors on the model's mesh, each rank
    keeping its shard of the data axis (every rank holds the whole
    batch, so nothing moves)."""
    from torch.distributed.tensor import distribute_tensor

    from ..parallel import sharding as sh

    mesh, out = model.mesh, {}
    for k, t in batch.items():
        spec = sh.spec_for(mesh, t.shape, logical[k], model.rules)
        out[k] = distribute_tensor(t, sh.compute_mesh(mesh), sh.placements_for(mesh, spec),
                                   src_data_rank=None)
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--preset", choices=["smoke", "100m", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", choices=["wsd", "cosine", "const"], default="wsd")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--compression", choices=["none", "bf16", "int8_ef"], default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's per-step loss, grad norm, lr and seconds, its "
                         "mesh and the peak device memory to this JSON file (rank 0)")
    ap.add_argument("--trace-out", default=None,
                    help="trace the run (runtime.trace) and write its Chrome-trace JSON here "
                         "(rank 0)")
    return ap


def main(argv: "list[str] | None" = None) -> dict:
    """Train; returns ``dict(model, params, opt_state, start_step, losses,
    grad_norms, lrs, step_s)`` (the per-step lists as host floats; on a
    mesh ``params`` and the moments are this rank's DTensors)."""
    args = _parser().parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from ..ckpt.manager import CheckpointManager
    from ..data.pipeline import DataConfig, Pipeline
    from ..device import resolve_device
    from ..models.config import ParallelConfig
    from ..models.model import Model
    from ..optim.adamw import (AdamWConfig, adamw_init, constant_schedule, cosine_schedule,
                               wsd_schedule)
    from ..runtime import trace
    from ..train.steps import make_train_step
    from .mesh import host_group_up, make_host_mesh

    cfg = build_model_config(args.arch, args.preset)
    pc = ParallelConfig(data_axes=("data",), remat="block")
    mesh = None
    lead = True  # this process prints and writes the checkpoints
    if host_group_up() or args.model_parallel > 1:
        import torch.distributed as dist
        from torch.distributed.tensor.experimental import implicit_replication

        mesh = make_host_mesh(args.model_parallel, device=args.device)
        dev = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" \
            else torch.device("cpu")
        lead = dist.get_rank() == 0
        on_mesh = implicit_replication  # the model's plain tensors join as replicated
    else:
        dev = resolve_device(args.device)
        on_mesh = contextlib.nullcontext
    say = print if lead else (lambda *a, **k: None)
    tracing = bool(args.trace_out) and lead
    if tracing:
        trace.enable()
    # on a mesh the params are DTensors placed by `parallel.sharding.rules_for_model`
    model = Model(cfg, pc, mesh=mesh, q_chunk=256, kv_chunk=256, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    params = model.train_params()
    n_params = sum(p.numel() for p in params.values())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    on = "" if mesh is None else f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
    say(f"arch={cfg.name} preset={args.preset} params={n_params/1e6:.1f}M device={where}{on}")

    sched = dict(
        wsd=wsd_schedule(args.lr, max(1, args.steps // 10), args.steps * 8 // 10,
                         max(1, args.steps // 10)),
        cosine=cosine_schedule(args.lr, max(1, args.steps // 10), args.steps),
        const=constant_schedule(args.lr),
    )[args.schedule]
    opt_cfg = AdamWConfig(compression=args.compression)
    opt_state = adamw_init(params, opt_cfg)

    ckpt = (CheckpointManager(args.ckpt_dir, keep_n=3, defer_snapshot=True)
            if args.ckpt_dir else None)
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        # restore template: the spec tree's leaves carry the shapes
        like = dict(p=model.specs(), o={k: model.specs() if isinstance(v, dict) else 0
                                        for k, v in opt_state.items()})
        places = None
        if mesh is not None:  # each leaf onto the mesh as its param lies; the step whole
            tree_places = model.tree_shardings()
            places = dict(p=tree_places, o={k: tree_places if isinstance(v, dict) else None
                                            for k, v in opt_state.items()})
        tree, _ = ckpt.restore(like, device=dev, shardings=places)
        model.load_tree(tree["p"])
        opt_state = {k: model.from_tree(v) if isinstance(v, dict) else v
                     for k, v in tree["o"].items()}
        start_step = int(opt_state["step"])
        say(f"resumed from step {start_step}")

    data = Pipeline(DataConfig(batch_per_host=args.batch, seq_len=args.seq,
                               vocab_size=cfg.vocab_size, seed=args.seed))
    step_fn = make_train_step(model, sched, opt_cfg, grad_accum=args.grad_accum)
    if mesh is not None:
        from .specs import batch_logical

        logical = batch_logical(cfg, train=True)

    stop = {"now": False}
    handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _sig(_s, _f):
            stop["now"] = True
        for s in (signal.SIGTERM, signal.SIGINT):
            handlers[s] = signal.signal(s, _sig)

    def save(step: int) -> None:
        snap = _snapshot(model, params, opt_state)  # a collective on a mesh: every rank
        if lead:
            ckpt.save(step, snap)

    out = dict(model=model, start_step=start_step, losses=[], grad_norms=[], lrs=[], step_s=[])
    ema = None
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v, device=dev) for k, v in data.get_batch(step).items()}
            if cfg.is_encoder_decoder:
                batch["frames"] = torch.zeros((args.batch, cfg.enc_seq, cfg.d_model),
                                              dtype=torch.bfloat16, device=dev)
            if cfg.n_patches:
                batch["patches"] = torch.zeros((args.batch, cfg.n_patches, cfg.d_model),
                                               dtype=torch.bfloat16, device=dev)
            if mesh is not None:
                batch = shard_batch(batch, model, logical)
            with on_mesh():
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss, lr, gnorm = (float(_whole(metrics[k])) for k in ("loss", "lr", "grad_norm"))
            dt = time.perf_counter() - t0  # the float()s above waited for the step
            out["losses"].append(loss)
            out["grad_norms"].append(gnorm)
            out["lrs"].append(lr)
            out["step_s"].append(dt)
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > 3.0 * ema and step > start_step + 2:
                say(f"[straggler-monitor] step {step} took {dt:.2f}s (ema {ema:.2f}s)")
            if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
                say(f"step {step:5d} loss {loss:.4f} lr {lr:.2e} gnorm {gnorm:.3f} {dt:.2f}s")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if stop["now"]:
                say("signal received — checkpointing and exiting")
                if ckpt:
                    save(step + 1)
                    ckpt.wait()
                break
        else:
            if ckpt:
                save(args.steps)
                ckpt.wait()
            say("training complete")
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
        if tracing:
            trace.disable()
            record = trace.export_chrome(args.trace_out)
            say(f"trace: {len(record['spans'])} spans to {args.trace_out}"
                + (f", {record['dropped']} dropped" if record["dropped"] else ""))
    out.update(params=params, opt_state=opt_state)
    if args.metrics_out and lead:
        import json

        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        mesh_shape = None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))
        with open(args.metrics_out, "w") as f:
            json.dump(dict(start_step=start_step, mesh=mesh_shape, peak_device_bytes=peak,
                           **{k: out[k] for k in ("losses", "grad_norms", "lrs", "step_s")}), f)
    return out


if __name__ == "__main__":
    from .mesh import torchrun_group

    with torchrun_group(_parser().parse_args().device):
        main()
