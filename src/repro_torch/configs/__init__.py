"""Architecture config registry.

Each assigned architecture has its own module defining ``CONFIG`` (the
exact assignment card) and the registry exposes reduced smoke variants for
CPU tests.  ``--arch <id>`` in the launchers resolves through here.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, SHAPES, ShapeConfig

ARCH_IDS = (
    "mamba2-780m",
    "minicpm-2b",
    "qwen1.5-4b",
    "gemma3-27b",
    "deepseek-coder-33b",
    "whisper-tiny",
    "recurrentgemma-9b",
    "internvl2-2b",
    "deepseek-moe-16b",
    "moonshot-v1-16b-a3b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


# Shape cells skipped per DESIGN.md §4 (sub-quadratic requirement for
# long_500k; whisper's decoder length cap).
SKIP_CELLS: dict[tuple[str, str], str] = {
    ("minicpm-2b", "long_500k"): "pure full attention — no sub-quadratic path",
    ("qwen1.5-4b", "long_500k"): "pure full attention — no sub-quadratic path",
    ("deepseek-coder-33b", "long_500k"): "pure full attention — no sub-quadratic path",
    ("internvl2-2b", "long_500k"): "pure full attention — no sub-quadratic path",
    ("deepseek-moe-16b", "long_500k"): "pure full attention — no sub-quadratic path",
    ("moonshot-v1-16b-a3b", "long_500k"): "pure full attention — no sub-quadratic path",
    ("whisper-tiny", "long_500k"): "enc-dec decoder max target length << 500k",
}


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for a in ARCH_IDS:
        for s in SHAPES:
            cells.append((a, s))
    return cells


def runnable_cells() -> list[tuple[str, str]]:
    return [c for c in all_cells() if c not in SKIP_CELLS]


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(arch)
    pat = cfg.pattern
    n_layers = len(pat) + max(1, cfg.first_dense_layers) if cfg.is_moe else max(
        2, len(pat)
    )
    kv = 1 if cfg.n_kv_heads == 1 else (4 if cfg.n_kv_heads == cfg.n_heads else 2)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=16 if cfg.window else 0,
        n_experts=8 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=2 if cfg.top_k else 0,
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        # dropless capacity so decode == forward exactly in smoke tests
        # (production uses the paper-standard 1.25 with overflow dropping)
        capacity_factor=8.0 if cfg.n_experts else 1.25,
        ssm_state=16 if cfg.ssm_state else 0,
        d_inner=128 if cfg.family == "ssm" else 0,
        ssm_head_dim=16,
        ssm_chunk=8,
        lru_width=64 if cfg.lru_width else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_seq=16 if cfg.enc_seq else 0,
        n_patches=8 if cfg.n_patches else 0,
        vocab_pad_multiple=1,
    )
