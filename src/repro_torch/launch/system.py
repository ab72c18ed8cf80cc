"""System-level comparison: workload-lowered rCiM vs a conventional
accelerator roofline.

Two halves:

  * rCiM side — `repro_torch.core.workloads` lowers a config-zoo model to
    primitive-tile counts per token and prices them through the port's
    fused torch back half (`evaluate_select_suite`) across the topology
    library.
  * baseline side — an `AcceleratorModel` (roofline constants from
    `launch.roofline` plus pJ/op energy coefficients) priced on the
    model's per-token flops / HBM bytes / link bytes, either analytic
    (`token_cost`) or measured from a dry-run record
    (`token_cost_from_dryrun`).

The roofline evaluation is a sweep: flops/bytes AND the bandwidth
parameters (HBM BW, link BW) are fp64 tensor operands on ``device``, so
an N-point bandwidth sweep is one pass of tensor ops.

Every entry point takes ``device=`` (default ``cuda``) and raises
without a card unless ``device="cpu"`` is passed::

    python -m repro_torch.launch.system --arch gemma3-27b --shape decode_32k --device cpu --hbm-sweep 4e11 8e11 1.6e12
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.analysis import registry as _registry
from repro_torch.configs import get_config
from repro_torch.core.workloads import (LoweredModel, SystemResult,
                                        conservation_report, evaluate_lowered,
                                        lower_config)
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig


# repro: kernel-module — host syncs in device-adjacent code are annotated


@dataclasses.dataclass(frozen=True)
class AcceleratorModel:
    """Conventional-accelerator cost model (TPU-class defaults).

    Energy coefficients are architectural constants in the style of the
    Eva-CiM system baseline: ~0.3 pJ per bf16 flop (MXU), ~31 pJ per
    HBM byte, ~10 pJ per inter-chip link byte.  Every default is a
    modelling constant of the reference's baseline accelerator (the
    rates are `launch.roofline`'s), not a measurement of any card.
    """

    name: str = "tpu-like"
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    pj_per_flop: float = 0.3
    pj_per_hbm_byte: float = 31.2
    pj_per_link_byte: float = 10.0
    weight_dtype_bytes: int = 2


DEFAULT_ACCEL = AcceleratorModel()


# ---------------------------------------------------------------------------
# Per-token cost of a (config, shape) cell
# ---------------------------------------------------------------------------


def token_cost(cfg: ModelConfig, shape: ShapeConfig,
               accel: AcceleratorModel = DEFAULT_ACCEL) -> dict:
    """Analytic per-token flops / HBM bytes / link bytes.

    flops: 2*N_active fwd (6*N_active train).  HBM: weight streaming
    amortized over the batch (3x in train for fwd+bwd re-reads) plus the
    KV read at decode; activation traffic is the ~12*d*L/token residual-
    stream estimate.  Link bytes default to 0 (single chip) — use
    `token_cost_from_dryrun` for measured multi-chip numbers.
    """
    n_active = cfg.n_active_params()
    w_bytes = n_active * accel.weight_dtype_bytes
    flops = (6.0 if shape.is_train else 2.0) * n_active
    if shape.kind == "decode":
        hbm = w_bytes / shape.global_batch
        ctx = shape.seq_len
        kv_layers = sum(1 for k in cfg.layer_kinds if k in ("attn", "local"))
        hd = cfg.resolved_head_dim
        # local layers re-read only the window
        kv = 0
        for k in cfg.layer_kinds:
            if k in ("attn", "local"):
                c = min(ctx, cfg.window) if (k == "local" and cfg.window) else ctx
                kv += 2 * cfg.n_kv_heads * hd * c * 2  # K+V, bf16
        hbm += kv
        del kv_layers
    else:
        reread = 3.0 if shape.is_train else 1.0
        hbm = reread * w_bytes / (shape.global_batch * shape.seq_len)
        hbm += 12 * cfg.d_model * cfg.n_layers * 2  # activation traffic
    return dict(flops=float(flops), hbm_bytes=float(hbm), link_bytes=0.0)


def token_cost_from_dryrun(record: dict, shape: ShapeConfig) -> dict:
    """Per-token cost from a dry-run record (`launch.dryrun`): the
    HLO-measured flops/HBM/link bytes of one step, divided by the tokens
    that step processes — the hook that threads *measured* costs into
    the sweep below."""
    rl = record["roofline"]
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    n_chips = max(1, int(record.get("n_chips", 1)))
    return dict(
        flops=float(rl["flops"]) * n_chips / tokens,
        hbm_bytes=float(rl["hbm_bytes"]) * n_chips / tokens,
        link_bytes=float(rl["link_bytes"]) * n_chips / tokens,
    )


# ---------------------------------------------------------------------------
# Roofline bandwidth sweep
# ---------------------------------------------------------------------------

BOTTLENECKS = ("compute", "memory", "collective")


def _roofline_core(flops, hbm_bytes, link_bytes, peak_flops, hbm_bw, link_bw) -> dict:
    """The roofline terms of a sweep: every operand an fp64 tensor on one
    device (the costs and the peak 0-d, the bandwidths the sweep's
    shape).  A zero link bandwidth means one chip (no collective time);
    the bottleneck is the argmax over (compute, memory, collective), the
    first winning ties."""
    compute = flops / peak_flops
    memory = hbm_bytes / hbm_bw
    coll = torch.where(link_bw > 0, link_bytes / link_bw.clamp_min(1.0), 0.0)
    compute, memory, coll = torch.broadcast_tensors(compute, memory, coll)
    token_s = torch.maximum(torch.maximum(compute, memory), coll)
    bottleneck = torch.argmax(torch.stack([compute, memory, coll], dim=-1), dim=-1)
    return dict(compute_s=compute, memory_s=memory, collective_s=coll,
                token_s=token_s, bottleneck=bottleneck)


def sweep_roofline(cost: dict,
                   hbm_bw: "float | Sequence[float]" = HBM_BW,
                   link_bw: "float | Sequence[float]" = LINK_BW,
                   peak_flops: float = PEAK_FLOPS,
                   device: "str | torch.device | None" = None) -> dict:
    """Roofline terms with every parameter an fp64 operand on ``device``.

    ``hbm_bw`` / ``link_bw`` may be scalars or 1-D sweeps (broadcast
    against each other); the returned numpy arrays have the broadcast
    shape (`_roofline_core` on ``device``).
    """
    dev = resolve_device(device)
    hbm = np.atleast_1d(np.asarray(hbm_bw, np.float64))  # repro: host-boundary
    link = np.atleast_1d(np.asarray(link_bw, np.float64))  # repro: host-boundary
    hbm, link = np.broadcast_arrays(hbm, link)

    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    out = _roofline_core(f64(cost["flops"]), f64(cost["hbm_bytes"]), f64(cost["link_bytes"]),
                         f64(peak_flops), f64(hbm), f64(link))
    # sweep-shaped (small): materialize for callers
    out = {k: v.cpu().numpy() for k, v in out.items()}  # repro: host-boundary
    out["hbm_bw"] = hbm.copy()
    out["link_bw"] = link.copy()
    return out


def baseline_cost(cost: dict, accel: AcceleratorModel = DEFAULT_ACCEL,
                  device: "str | torch.device | None" = None) -> dict:
    """Baseline per-token latency (roofline) + energy (pJ coefficients)."""
    sweep = sweep_roofline(cost, hbm_bw=accel.hbm_bw, link_bw=accel.link_bw,
                           peak_flops=accel.peak_flops, device=device)
    energy_j = (cost["flops"] * accel.pj_per_flop
                + cost["hbm_bytes"] * accel.pj_per_hbm_byte
                + cost["link_bytes"] * accel.pj_per_link_byte) * 1e-12
    return dict(
        accel=accel.name,
        flops_per_token=cost["flops"],
        hbm_bytes_per_token=cost["hbm_bytes"],
        link_bytes_per_token=cost["link_bytes"],
        # repro: host-boundary — the materialized sweep's first point
        latency_per_token_s=float(sweep["token_s"][0]),
        energy_per_token_j=float(energy_j),  # repro: host-boundary — a host scalar
        bottleneck=BOTTLENECKS[int(sweep["bottleneck"][0])],
        compute_s=float(sweep["compute_s"][0]),  # repro: host-boundary
        memory_s=float(sweep["memory_s"][0]),  # repro: host-boundary
        collective_s=float(sweep["collective_s"][0]),  # repro: host-boundary
    )


# ---------------------------------------------------------------------------
# End-to-end comparison
# ---------------------------------------------------------------------------


def compare_system(arch: str, shape_name: str = "decode_32k",
                   topologies=None, model=None, mode: str = "physical",
                   discipline: str = "list", n_units: int = 8192,
                   accel: AcceleratorModel = DEFAULT_ACCEL,
                   hbm_bw_sweep: "Sequence[float] | None" = None,
                   link_bw_sweep: "Sequence[float] | None" = None,
                   dryrun_record: "dict | None" = None,
                   device: "str | torch.device | None" = None) -> dict:
    """rCiM vs conventional roofline for one (arch, shape) cell, both
    sides priced on ``device``.

    Returns a JSON-safe record: the lowering (+ conservation check), the
    rCiM per-layer/per-token cost, the baseline per-token cost, their
    ratios, and (optionally) a bandwidth sweep of the baseline."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    lowered: LoweredModel = lower_config(cfg, shape)
    cons = conservation_report(lowered)
    rcim: SystemResult = evaluate_lowered(
        lowered, topologies=topologies, model=model, mode=mode,
        discipline=discipline, n_units=n_units, device=dev,
    )
    cost = (token_cost_from_dryrun(dryrun_record, shape)
            if dryrun_record is not None else token_cost(cfg, shape, accel))
    base = baseline_cost(cost, accel, device=dev)

    rec = dict(
        arch=arch, shape=shape_name, mode=mode, discipline=discipline,
        macs_per_token=int(lowered.macs_per_token()),
        tiles_per_token={k: int(v) for k, v in lowered.tiles_per_token().items()},
        ops_per_token={k: int(v) for k, v in cons["ops_per_token"].items()},
        conserved=bool(cons["ok"]),
        rcim=rcim.as_dict(),
        baseline=base,
        energy_ratio_rcim_over_accel=(
            rcim.energy_per_token_j / base["energy_per_token_j"]
            if base["energy_per_token_j"] else math.inf),
        latency_ratio_rcim_over_accel=(
            rcim.latency_per_token_s / base["latency_per_token_s"]
            if base["latency_per_token_s"] else math.inf),
    )
    if hbm_bw_sweep is not None or link_bw_sweep is not None:
        sweep = sweep_roofline(
            cost,
            hbm_bw=hbm_bw_sweep if hbm_bw_sweep is not None else accel.hbm_bw,
            link_bw=link_bw_sweep if link_bw_sweep is not None else accel.link_bw,
            peak_flops=accel.peak_flops, device=dev,
        )
        rec["bw_sweep"] = {k: v.tolist() for k, v in sweep.items()}  # repro: host-boundary
    return rec


def _ex_roofline_sweep(device):
    def f64(x):
        return torch.tensor(x, dtype=torch.float64, device=device)

    bw = f64([1.0e11, 2.0e11])
    return _registry.KernelExample(
        fn=_roofline_core, args=(f64(1.0e12), f64(1.0e9), f64(0.0), f64(1.0e15), bw, bw)
    )


_registry.register_kernel("roofline_sweep", __name__, _ex_roofline_sweep)


def main(argv: "Sequence[str] | None" = None) -> dict:
    """The CLI: print one cell's record as JSON and return it."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--shape", default="decode_32k", choices=sorted(SHAPES))
    ap.add_argument("--n-units", type=int, default=8192)
    ap.add_argument("--hbm-sweep", type=float, nargs="*", default=None,
                    help="HBM BW points (B/s) for the bandwidth sweep")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "torch path on the host)")
    args = ap.parse_args(argv)
    rec = compare_system(args.arch, args.shape, n_units=args.n_units,
                         hbm_bw_sweep=args.hbm_sweep, device=args.device)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":  # pragma: no cover
    main()
