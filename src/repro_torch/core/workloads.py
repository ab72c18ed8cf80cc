"""Workload lowering: NN layer primitives -> rCiM gate-op streams.

The paper's pipeline (Algorithm I) takes an RTL netlist, maps it to
NAND2/NOR2/NOT, and schedules the per-level op stream onto an SRAM
topology.  This module closes the loop from the *application* side
(Eva-CiM direction): it decomposes the NN layer blocks of the config zoo
(`repro_torch.configs`) into counts of three exactly-constructed primitive
tiles, characterizes each tile once into the same `AigStats` shape the
schedule/evaluate passes consume, and exposes the result as a
`SuiteTable` so the port's fused torch back half
(`batch.evaluate_select_suite`) prices a whole model per token.

Primitive tiles (exact gate-level constructions, verified against
integer arithmetic by tests/test_torch_workloads.py):

  * ``mac8``  — 8x8 Wallace-tree multiplier + 16-bit accumulate add;
                one tile == one int8 MAC (matmul work unit).
  * ``add16`` — 16-bit Brent-Kung adder; one tile == one elementwise
                accumulate/residual/normalizer step.
  * ``max8``  — 8-bit compare-select (>= + mux); one tile == one
                gating / activation-select / running-max step.

Lowering contract (per token, per layer; mirrors the param counting of
`ModelConfig.n_params` so matmul MAC counts equal the active weight
count of that layer's matmuls, MoE-aware):

  * matmul MACs            -> ``mac8`` tiles (1 tile per MAC)
  * attention score/AV     -> ``mac8`` tiles, 2 * ctx * head_dim * heads
  * norms / residuals /
    softmax normalizers    -> ``add16`` tiles
  * activations / gates /
    softmax running max    -> ``max8`` tiles

Elementwise counts are architectural approximations (documented at each
site); the matmul term dominates by >99% for every config in the zoo.

Conservation invariant (asserted for every config): for each
primitive, the per-level op stream sums to the tile's op totals, so any
per-token/per-layer total computed from level streams equals the same
total computed from `AigStats` totals x tile counts.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from functools import lru_cache
from typing import Mapping, Sequence

import numpy as np
import torch

from .aig import CONST0, Aig, AigStats
from .batch import SuiteTable, TopologyTable, evaluate_select_suite
from .circuits import (Word, brent_kung_add, csa_reduce, greater_equal,
                       mux_word, new_inputs)
from .sram import TOPOLOGY_LIBRARY, EnergyModel, SramTopology

# ---------------------------------------------------------------------------
# Primitive tiles
# ---------------------------------------------------------------------------


def mac_tile(bits: int = 8) -> Aig:
    """``bits x bits`` multiplier + ``2*bits`` accumulate: one MAC.

    Wallace construction (partial products -> CSA 3:2 reduction ->
    Brent-Kung final add) — few, wide levels, the structure rCiM
    schedules well.  The accumulate is modular in ``2*bits`` (the final
    carry is dropped), matching a fixed-width accumulator register.
    """
    aig = Aig(name=f"mac{bits}")
    a = new_inputs(aig, bits)
    b = new_inputs(aig, bits)
    acc = new_inputs(aig, 2 * bits)
    rows: list[Word] = []
    for i in range(bits):
        rows.append([CONST0] * i + [aig.g_and(x, b[i]) for x in a])
    rows.append(acc)
    s_row, c_row = csa_reduce(aig, rows, 2 * bits)
    out, _ = brent_kung_add(aig, s_row, c_row)
    for lit in out:
        aig.add_po(lit)
    return aig


def add_tile(bits: int = 16) -> Aig:
    """``bits``-wide Brent-Kung adder: one elementwise accumulate."""
    aig = Aig(name=f"add{bits}")
    a = new_inputs(aig, bits)
    b = new_inputs(aig, bits)
    out, _ = brent_kung_add(aig, a, b)
    for lit in out:
        aig.add_po(lit)
    return aig


def max_tile(bits: int = 8) -> Aig:
    """``bits``-wide compare-select (max): one gating/activation step."""
    aig = Aig(name=f"max{bits}")
    a = new_inputs(aig, bits)
    b = new_inputs(aig, bits)
    ge = greater_equal(aig, a, b)
    for lit in mux_word(aig, ge, a, b):
        aig.add_po(lit)
    return aig


_TILE_BUILDERS = {"mac": mac_tile, "add": add_tile, "max": max_tile}

# Canonical primitive set: name -> (family, bit width).
PRIMITIVES: tuple[tuple[str, str, int], ...] = (
    ("mac8", "mac", 8),
    ("add16", "add", 16),
    ("max8", "max", 8),
)


@lru_cache(maxsize=None)
def primitive_aigs() -> "dict[str, Aig]":
    return {name: _TILE_BUILDERS[fam](bits) for name, fam, bits in PRIMITIVES}


@lru_cache(maxsize=None)
def primitive_stats() -> "dict[str, AigStats]":
    """Characterized (`ChaAIG`) per-tile op streams, built once."""
    return {name: aig.characterize() for name, aig in primitive_aigs().items()}


# ---------------------------------------------------------------------------
# Layer lowering
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerLowering:
    """Tile counts for ONE layer of ``kind`` (per token); the model has
    ``count`` such layers."""

    kind: str
    count: int
    tiles: Mapping[str, int]  # primitive name -> tiles per token per layer


def _ffn_active_macs(cfg) -> int:
    """MACs/token of one FFN block — the *active* weight count (mirrors
    `ModelConfig.n_active_params`: top_k + shared experts + router)."""
    d = cfg.d_model
    if cfg.is_moe:
        e_ff = cfg.moe_d_ff
        return (cfg.top_k + cfg.n_shared_experts) * 3 * d * e_ff + d * cfg.n_experts
    return 3 * d * cfg.d_ff


def _ffn_act_width(cfg) -> int:
    """Elementwise width of the FFN gate activation (active experts)."""
    if cfg.is_moe:
        return (cfg.top_k + cfg.n_shared_experts) * cfg.moe_d_ff
    return cfg.d_ff


def _context_len(cfg, shape, kind: str) -> int:
    """Effective attended context per token: full ``seq_len`` at decode,
    the causal average ``seq_len/2`` in train/prefill; local attention
    caps at the window."""
    ctx = shape.seq_len if shape.kind == "decode" else max(1, shape.seq_len // 2)
    if kind == "local" and cfg.window:
        ctx = min(ctx, cfg.window)
    return ctx


def _lower_layer(cfg, shape, kind: str) -> dict[str, int]:
    """Per-token tile counts for one layer of ``kind`` (see module doc)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    mac = add = mx = 0
    if kind in ("attn", "local", "xattn"):
        ctx = _context_len(cfg, shape, kind)
        mac += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)  # qkv proj
        mac += cfg.n_heads * hd * d                          # o proj
        mac += 2 * ctx * hd * cfg.n_heads                    # QK^T + AV
        mac += _ffn_active_macs(cfg)
        # softmax: running max + normalizer accumulate per (head, key)
        mx += cfg.n_heads * ctx
        add += cfg.n_heads * ctx
        mx += _ffn_act_width(cfg)                            # gate activation
        # 2 norms (sum-of-squares accumulate + scale) + 2 residuals
        add += 2 * (2 * d) + 2 * d
        if kind == "xattn":
            # decoder cross-attention sub-block over the encoder output
            enc = max(1, cfg.enc_seq)
            mac += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
            mac += cfg.n_heads * hd * d
            mac += 2 * enc * hd * cfg.n_heads
            mx += cfg.n_heads * enc
            add += cfg.n_heads * enc
            add += 2 * d + d  # extra norm + residual
    elif kind == "ssm":
        di = cfg.d_inner or 2 * d
        nh = di // cfg.ssm_head_dim
        mac += d * (2 * di + 2 * cfg.ssm_state + nh)         # in proj
        mac += di * d                                        # out proj
        mac += di * cfg.conv_width                           # depthwise conv
        mac += 2 * di * cfg.ssm_state                        # state update
        mx += di                                             # silu gate
        add += 2 * d + d                                     # 1 norm + residual
    elif kind == "rglru":
        w = cfg.lru_width or d
        mac += d * w * 2 + w * d + w * 3                     # gates + proj
        mac += _ffn_active_macs(cfg)
        mx += w + _ffn_act_width(cfg)                        # recurrence + ffn gates
        add += w                                             # recurrence blend
        add += 2 * (2 * d) + 2 * d                           # 2 norms + 2 residuals
    else:  # pragma: no cover - config zoo only emits the four kinds
        raise ValueError(f"unknown layer kind {kind!r}")
    return {"mac8": mac, "add16": add, "max8": mx}


@dataclasses.dataclass(frozen=True)
class LoweredModel:
    """A model config lowered to primitive-tile counts per token."""

    arch: str
    shape: str
    layers: tuple[LayerLowering, ...]
    prims: Mapping[str, AigStats]

    def tiles_per_token(self) -> dict[str, int]:
        out: dict[str, int] = {name: 0 for name in self.prims}
        for layer in self.layers:
            for name, n in layer.tiles.items():
                out[name] += layer.count * n
        return out

    def macs_per_token(self) -> int:
        return self.tiles_per_token().get("mac8", 0)

    def ops_per_token(self) -> dict[str, int]:
        """Total NAND/NOR/NOT executions per token, from stats totals."""
        tiles = self.tiles_per_token()
        out = {"nand": 0, "nor": 0, "inv": 0}
        for name, n in tiles.items():
            s = self.prims[name]
            out["nand"] += n * s.nand_count
            out["nor"] += n * s.nor_count
            out["inv"] += n * s.inv_count
        return out

    def ops_per_token_from_levels(self) -> dict[str, int]:
        """Same totals recomputed from the per-level streams — must equal
        `ops_per_token` exactly (the conservation invariant)."""
        tiles = self.tiles_per_token()
        out = {"nand": 0, "nor": 0, "inv": 0}
        for name, n in tiles.items():
            for lvl in self.prims[name].ops_per_level:
                for k in out:
                    out[k] += n * lvl.get(k, 0)
        return out


def lower_config(cfg, shape) -> LoweredModel:
    """Lower ``cfg``'s layer stack under input shape ``shape`` into
    per-token primitive-tile counts (see module docstring)."""
    kinds = collections.Counter(cfg.layer_kinds)
    layers = tuple(
        LayerLowering(kind=k, count=c, tiles=_lower_layer(cfg, shape, k))
        for k, c in sorted(kinds.items())
    )
    return LoweredModel(arch=cfg.name, shape=shape.name, layers=layers,
                        prims=primitive_stats())


def conservation_report(lowered: LoweredModel) -> dict:
    """Check the lowering conservation invariant (CI asserts ``ok``).

    Per primitive: the per-level stream sums to the (nand, nor, inv)
    totals AND to ``n_ands``-consistent gate counts; per model: totals
    computed from level streams equal totals from stats totals.
    """
    per_prim = {}
    for name, s in lowered.prims.items():
        mat = s.ops_matrix()  # (n_levels, 3) in (nand, nor, inv) order
        level_sums = mat.sum(axis=0)
        totals = np.array([s.nand_count, s.nor_count, s.inv_count])
        per_prim[name] = dict(
            levels_match_totals=bool((level_sums == totals).all()),
            n_levels=int(s.n_levels),
            total_gates=int(s.total_gates),
        )
    by_totals = lowered.ops_per_token()
    by_levels = lowered.ops_per_token_from_levels()
    ok = all(p["levels_match_totals"] for p in per_prim.values()) and \
        by_totals == by_levels
    return dict(ok=bool(ok), per_primitive=per_prim,
                ops_per_token=by_totals, ops_per_token_from_levels=by_levels)


# ---------------------------------------------------------------------------
# Evaluation through the fused torch back half
# ---------------------------------------------------------------------------


def primitive_suite():
    """The primitive tiles as a `SuiteTable` (one trivial recipe per
    tile), the input shape `evaluate_suite`/`evaluate_select_suite`
    consume."""
    return SuiteTable.from_cha(
        {name: {(): stats} for name, stats in primitive_stats().items()}
    )


@dataclasses.dataclass(frozen=True)
class SystemResult:
    """rCiM cost of one lowered model across a topology set."""

    arch: str
    shape: str
    n_units: int
    winners: Mapping[str, str]            # primitive -> winning topology name
    tile_energy_nj: Mapping[str, float]   # per single tile
    tile_latency_ns: Mapping[str, float]
    tiles_per_token: Mapping[str, int]
    per_layer: tuple[dict, ...]           # per layer-kind energy/latency
    energy_per_token_j: float
    latency_per_token_s: float

    def as_dict(self) -> dict:
        return dict(
            arch=self.arch, shape=self.shape, n_units=self.n_units,
            winners=dict(self.winners),
            tile_energy_nj=dict(self.tile_energy_nj),
            tile_latency_ns=dict(self.tile_latency_ns),
            tiles_per_token={k: int(v) for k, v in self.tiles_per_token.items()},
            per_layer=list(self.per_layer),
            energy_per_token_j=self.energy_per_token_j,
            latency_per_token_s=self.latency_per_token_s,
        )


def evaluate_lowered(
    lowered: LoweredModel,
    topologies: "Sequence[SramTopology] | None" = None,
    model: "EnergyModel | None" = None,
    mode: str = "physical",
    discipline: str = "list",
    n_units: int = 8192,
    device: "str | torch.device | None" = None,
) -> SystemResult:
    """Price a lowered model on rCiM: pick the best topology per
    primitive tile via the fused torch back half on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``), then scale
    by tile counts on the host.

    ``n_units``: rCiM macro arrays operating in parallel (a chip-scale
    deployment instantiates thousands of small macros); energy is
    parallelism-invariant, latency divides by ``n_units``.
    """
    topos = tuple(topologies) if topologies is not None else TOPOLOGY_LIBRARY
    suite = primitive_suite()
    table = TopologyTable.from_topologies(topos)
    _, sel = evaluate_select_suite(
        suite, table, model=model, mode=mode, discipline=discipline,
        device=device,
    )
    # winner_idx is (C, V) flat topology-major over (T, R); R == 1 here.
    idx = np.asarray(sel.winner_idx).reshape(len(suite.circuits), -1)[:, 0]
    energy = np.asarray(sel.winner_metrics["energy_nj"]).reshape(idx.shape[0], -1)[:, 0]
    latency = np.asarray(sel.winner_metrics["latency_ns"]).reshape(idx.shape[0], -1)[:, 0]
    winners = {c: topos[int(idx[i])].name for i, c in enumerate(suite.circuits)}
    e_nj = {c: float(energy[i]) for i, c in enumerate(suite.circuits)}
    t_ns = {c: float(latency[i]) for i, c in enumerate(suite.circuits)}

    per_layer = []
    total_e = 0.0
    total_t = 0.0
    for layer in lowered.layers:
        le = sum(n * e_nj[p] for p, n in layer.tiles.items()) * 1e-9
        lt = sum(n * t_ns[p] for p, n in layer.tiles.items()) * 1e-9 / n_units
        per_layer.append(dict(
            kind=layer.kind, count=layer.count,
            tiles={k: int(v) for k, v in layer.tiles.items()},
            energy_per_token_j=le * layer.count,
            latency_per_token_s=lt * layer.count,
        ))
        total_e += le * layer.count
        total_t += lt * layer.count

    return SystemResult(
        arch=lowered.arch, shape=lowered.shape, n_units=n_units,
        winners=winners, tile_energy_nj=e_nj, tile_latency_ns=t_ns,
        tiles_per_token=lowered.tiles_per_token(), per_layer=tuple(per_layer),
        energy_per_token_j=total_e, latency_per_token_s=total_t,
    )
