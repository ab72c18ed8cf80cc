"""Training launcher of the port (the end-to-end training loop), on one device.

``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is asked for.  Presets: ``full`` (the published
config), ``smoke`` (the reduced CPU config) and ``100m`` (about 100M
params, the family's block pattern kept).  Params are fp32 masters, the
compute bf16, each scan group under `torch.utils.checkpoint`
(``remat="block"``).

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

Examples::

    python -m repro_torch.launch.train --device cpu --preset smoke --steps 8
    python -m repro_torch.launch.train --preset 100m --ckpt-dir /tmp/ck --ckpt-every 2
    python -m repro_torch.launch.train --preset 100m --ckpt-dir /tmp/ck --resume
    python -m repro_torch.launch.train --arch minicpm-2b --preset full --steps 6
"""

from __future__ import annotations

import argparse
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


def _snapshot(model, params: dict, opt_state: dict) -> dict:
    """``dict(p=params, o=opt_state)`` in the reference's layout, as fresh
    device tensors (the train step writes the live ones in place)."""
    o = {k: model.to_tree(v) if isinstance(v, dict) else v.clone() for k, v in opt_state.items()}
    return dict(p=model.to_tree(params), o=o)


def main(argv: "list[str] | None" = None) -> dict:
    """Train; returns ``dict(model, params, opt_state, start_step, losses,
    grad_norms, lrs, step_s)`` (the per-step lists as host floats)."""
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
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.model_parallel > 1:
        raise NotImplementedError("--model-parallel > 1 shards the model over a mesh "
                                  "(parallel/sharding.py), which the port has not ported")

    import torch

    from ..ckpt.manager import CheckpointManager
    from ..data.pipeline import DataConfig, Pipeline
    from ..device import resolve_device
    from ..models.config import ParallelConfig
    from ..models.model import Model
    from ..optim.adamw import (AdamWConfig, adamw_init, constant_schedule, cosine_schedule,
                               wsd_schedule)
    from ..train.steps import make_train_step

    dev = resolve_device(args.device)
    cfg = build_model_config(args.arch, args.preset)
    pc = ParallelConfig(data_axes=("data",), remat="block")
    model = Model(cfg, pc, q_chunk=256, kv_chunk=256, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    params = model.train_params()
    n_params = sum(p.numel() for p in params.values())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"arch={cfg.name} preset={args.preset} params={n_params/1e6:.1f}M device={where}")

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
        tree, _ = ckpt.restore(like, device=dev)
        model.load_tree(tree["p"])
        opt_state = {k: model.from_tree(v) if isinstance(v, dict) else v
                     for k, v in tree["o"].items()}
        start_step = int(opt_state["step"])
        print(f"resumed from step {start_step}")

    data = Pipeline(DataConfig(batch_per_host=args.batch, seq_len=args.seq,
                               vocab_size=cfg.vocab_size, seed=args.seed))
    step_fn = make_train_step(model, sched, opt_cfg, grad_accum=args.grad_accum)

    stop = {"now": False}
    handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _sig(_s, _f):
            stop["now"] = True
        for s in (signal.SIGTERM, signal.SIGINT):
            handlers[s] = signal.signal(s, _sig)

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
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss, lr, gnorm = (float(metrics[k]) for k in ("loss", "lr", "grad_norm"))
            dt = time.perf_counter() - t0  # the float()s above waited for the step
            out["losses"].append(loss)
            out["grad_norms"].append(gnorm)
            out["lrs"].append(lr)
            out["step_s"].append(dt)
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > 3.0 * ema and step > start_step + 2:
                print(f"[straggler-monitor] step {step} took {dt:.2f}s (ema {ema:.2f}s)")
            if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} lr {lr:.2e} gnorm {gnorm:.3f} {dt:.2f}s")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, _snapshot(model, params, opt_state))
            if stop["now"]:
                print("signal received — checkpointing and exiting")
                if ckpt:
                    ckpt.save(step + 1, _snapshot(model, params, opt_state))
                    ckpt.wait()
                break
        else:
            if ckpt:
                ckpt.save(args.steps, _snapshot(model, params, opt_state))
                ckpt.wait()
            print("training complete")
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    out.update(params=params, opt_state=opt_state)
    return out


if __name__ == "__main__":
    main()
