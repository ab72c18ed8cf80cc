"""Roofline-term extraction from compiled dry-run artifacts.

Hardware constants (TPU v5e, per assignment): 197 TFLOP/s bf16 per chip,
819 GB/s HBM, ~50 GB/s/link ICI.  They are modelling inputs: the
baseline accelerator of `launch.system.AcceleratorModel` is priced with
them, and none of them is a measurement of the card the port runs on.

Sources:
  * ``compiled.cost_analysis()`` -> HLO flops / bytes accessed (per-device,
    the module is already SPMD-partitioned when lowered under a mesh).
  * collective bytes are NOT in cost_analysis: we parse the optimized HLO
    text and sum the shapes of all-gather / all-reduce / reduce-scatter /
    all-to-all / collective-permute ops, converting each to *bytes crossing
    links per chip* with the standard ring factors:

        all-reduce       2 (n-1)/n x payload
        all-gather         (n-1)   x shard   (result = n shards)
        reduce-scatter     (n-1)/n x payload (payload = n x result)
        all-to-all         (n-1)/n x payload
        collective-permute       1 x payload

    where n is the replica-group size parsed from the op (iota or explicit
    group list), falling back to the model-axis size.
"""

from __future__ import annotations

import dataclasses
import re

PEAK_FLOPS = 197e12  # bf16 / chip
HBM_BW = 819e9  # B/s
LINK_BW = 50e9  # B/s per ICI link

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_COLL_RE = re.compile(
    r"(\w[\w.\-]*)\s*=\s*"            # result name
    r"(?:\(([^)]*)\)|([a-z0-9_\[\]{},\. ]+?))\s*"  # result shape (maybe tuple)
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


_GROUP_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[(\d+)\]")
_GROUP_LIST_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")


def _group_size(line: str, default: int) -> int:
    m = _GROUP_IOTA_RE.search(line)
    if m:
        # iota form [G, S] <= [N]: groups of size S
        return max(1, int(m.group(2)))
    m = _GROUP_LIST_RE.search(line)
    if m:
        return max(1, len(m.group(1).split(",")))
    return default


@dataclasses.dataclass
class CollectiveStats:
    total_link_bytes: float = 0.0
    by_kind: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0

    def add(self, kind: str, link_bytes: float):
        self.total_link_bytes += link_bytes
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + link_bytes
        self.n_ops += 1


def collective_bytes(hlo_text: str, default_group: int) -> CollectiveStats:
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        line = line.strip()
        m = _COLL_RE.search(line)
        if not m:
            continue
        if ("-done" in line.split("=")[1][:40]) or ".clone" in m.group(1):
            pass  # -done ops carry no shape work; clones are fine to count once
        if re.search(r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)-done", line):
            continue
        kind = m.group(4)
        shape_str = m.group(2) or m.group(3) or ""
        result_bytes = _shape_bytes(shape_str)
        if result_bytes == 0:
            continue
        n = _group_size(line, default_group)
        if kind == "all-reduce":
            link = 2.0 * (n - 1) / n * result_bytes
        elif kind == "all-gather":
            link = (n - 1) / n * result_bytes  # result is the full gather
        elif kind == "reduce-scatter":
            link = (n - 1) * result_bytes  # result is one shard
        elif kind == "all-to-all":
            link = (n - 1) / n * result_bytes
        else:  # collective-permute
            link = float(result_bytes)
        stats.add(kind, link)
    return stats


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    link_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float
    model_flops_per_chip: float
    useful_ratio: float
    coll_breakdown: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(
    cost: dict,
    coll: CollectiveStats,
    n_chips: int,
    model_flops_total: float,
) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    coll_s = coll.total_link_bytes / LINK_BW
    terms = dict(compute=compute_s, memory=memory_s, collective=coll_s)
    bottleneck = max(terms, key=terms.get)
    per_chip_model = model_flops_total / n_chips
    return Roofline(
        flops=flops,
        hbm_bytes=hbm,
        link_bytes=coll.total_link_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        bottleneck=bottleneck,
        model_flops_total=model_flops_total,
        model_flops_per_chip=per_chip_model,
        useful_ratio=(per_chip_model / flops) if flops else 0.0,
        coll_breakdown=dict(coll.by_kind),
    )


def model_flops(cfg, shape, n_layers_factor: float = 1.0) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference fwd) per the standard
    counting; N = active params (MoE-aware), D = tokens processed."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
