"""Training launcher of the port: so far only `build_model_config`.

The three presets of the reference's launcher: ``full`` (the published
config), ``smoke`` (the reduced CPU config) and ``100m`` (about 100M
params, the family's block pattern kept).  The training loop comes with
the training slice.
"""

from __future__ import annotations

import dataclasses


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
