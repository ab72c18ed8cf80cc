"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake mesh.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell with XLA over 512 placeholder host devices.  For every
cell `run_cell`:
    1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod)
       over the fake 512-rank process group (`launch.mesh`),
    2. builds meta DTensor stand-ins (no allocation) for params, optimizer
       state, inputs and KV caches, placed by the logical-axis rules
       (`launch.specs`),
    3. runs the step once on them under ``implicit_replication``: DTensor's
       sharding propagation plays GSPMD's part, inserting the collectives,
    4. reads per-device flops, HBM bytes, collective link bytes and the
       peak of live local bytes off the trace (`launch.costparse`),
    5. derives the three roofline terms (`launch.roofline`) and writes a
       JSON record under ``out_dir`` (idempotent: a cell already recorded
       is read back, so a killed run resumes where it left off).

An op DTensor has no sharding strategy for fails its cell with the op's
name, as a cell the reference cannot compile fails there.

The record has the reference's keys.  ``lower_s`` is the trace time and
``compile_s`` 0.0 (nothing is compiled); ``memory`` holds the local bytes
of the arguments, of the outputs, the trace's peak of live local bytes
allocated by the step (``temp``, its new outputs included) and the donated
arguments (``alias``, updated in place); ``hbm_per_device_gb`` is
argument + temp.  The roofline constants
are the reference's TPU v5e modelling inputs (`launch.roofline`), not
measurements of any card: the explorer models the reference's pod.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi    # 2-pod pass
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors, each storage once."""
    from torch.distributed.tensor import DTensor

    seen: dict[int, int] = {}
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, overrides: dict | None = None,
             tag: str = "", mesh_shape: tuple | None = None) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from ..configs import SKIP_CELLS
    from ..models.config import SHAPES
    from .costparse import CostMode
    from .mesh import make_production_mesh
    from .roofline import CollectiveStats, model_flops, roofline_terms
    from .specs import CellSpec

    mesh_name = "multi" if multi_pod else "single"
    key = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, key + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    if (arch, shape_name) in SKIP_CELLS:
        rec = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                   skipped=SKIP_CELLS[(arch, shape_name)])
        _write(path, rec)
        return rec

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, mesh_shape=mesh_shape)
    n_chips = mesh.size()
    cell = CellSpec(arch, shape_name, mesh, **(overrides or {}))
    fn, args, _, donate = cell.step_fn_and_args()
    arg_bytes = _local_bytes(args)
    alias_bytes = _local_bytes([args[i] for i in donate])

    with implicit_replication(), CostMode(default_group=mesh.shape[-1], device=cell.device) as cm:
        out = fn(*args)
    t_trace = time.time() - t0
    hc = cm.cost
    hc.trip_counts = {f"seg{i}": seg.n_groups
                      for i, seg in enumerate(cell.model.segments) if seg.scanned}

    coll = CollectiveStats(total_link_bytes=hc.link_bytes,
                           by_kind=hc.coll_by_kind, n_ops=hc.n_collectives)
    mf = model_flops(cell.cfg, SHAPES[shape_name])
    rl = roofline_terms(
        {"flops": hc.flops, "bytes accessed": hc.hbm_bytes}, coll, n_chips, mf
    )
    mem_rec = dict(
        argument_size_in_bytes=arg_bytes,
        output_size_in_bytes=_local_bytes(out),
        temp_size_in_bytes=hc.peak_bytes,
        generated_code_size_in_bytes=0,
        alias_size_in_bytes=alias_bytes,
    )
    # The reference takes argument + temp - alias from XLA's analysis.  The
    # port's donated arguments are written in place (never a second
    # buffer) and its temp already holds the outputs it allocates, so the
    # peak is argument + temp, with nothing counted twice to take back.
    hbm_per_device = mem_rec["argument_size_in_bytes"] + mem_rec["temp_size_in_bytes"]

    rec = dict(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        tag=tag,
        n_chips=int(n_chips),
        lower_s=round(t_trace, 1),
        compile_s=0.0,
        memory=mem_rec,
        hbm_per_device_gb=round(hbm_per_device / 2**30, 3),
        cost=dict(flops=hc.flops, bytes_accessed=hc.hbm_bytes,
                  note="per-device count of the traced eager step (loops unrolled)"),
        roofline=rl.as_dict(),
        n_collectives=coll.n_ops,
        trip_counts=hc.trip_counts,
    )
    _write(path, rec)
    return rec


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1)
    os.rename(tmp, path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS
    from ..models.config import SHAPES

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                label = f"{arch:22s} {shape:12s} {'multi' if multi else 'single'}"
                try:
                    rec = run_cell(arch, shape, multi, args.out, force=args.force)
                    if "skipped" in rec:
                        n_skip += 1
                        print(f"SKIP {label}: {rec['skipped']}", flush=True)
                    else:
                        n_ok += 1
                        r = rec["roofline"]
                        print(
                            f"OK   {label}: hbm/dev={rec['hbm_per_device_gb']:.2f}GB "
                            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                            f"coll={r['collective_s']:.4f}s -> {r['bottleneck']} "
                            f"(trace {rec['lower_s']:.0f}s)",
                            flush=True,
                        )
                except Exception as e:  # noqa: BLE001 -- a failed cell is a bug to report
                    n_fail += 1
                    root = e  # DTensor wraps the op it cannot shard
                    while root.__cause__ or root.__context__:
                        root = root.__cause__ or root.__context__
                    why = f" <- {type(root).__name__}: {root}" if root is not e else ""
                    print(f"FAIL {label}: {type(e).__name__}: {e}{why}", flush=True)
                    traceback.print_exc()
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
