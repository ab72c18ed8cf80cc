"""The benchmark's hold on the program: the port's model built from a
configuration file and loaded with the benchmark's weights.

Everything the benchmark takes from `repro_torch` passes through here and
the drivers: `Model` (as `launch/serve.py` and `launch/train.py` build
it), `ServeEngine`, `make_train_step` with `adamw_init` and the WSD
schedule.  `build` and `load` ask the configuration's architecture
(`arch.module`) for the ``ModelConfig`` and the parameters' names;
`model_config` and `param_name` here are the decoder's.
"""

from __future__ import annotations

import torch

from . import arch, weights
from .arch import Arch


def model_config(a: Arch):
    """The decoder's ``ModelConfig``."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(
        name=a.name, family="moe" if a.is_moe else "dense", n_layers=a.n_layers,
        d_model=a.d_model, n_heads=a.n_heads, n_kv_heads=a.n_kv_heads, head_dim=a.head_dim,
        d_ff=a.d_ff, vocab_size=a.vocab_size, pattern=("attn",), n_experts=a.n_experts,
        n_shared_experts=a.n_shared_experts, top_k=a.top_k, moe_d_ff=a.moe_d_ff,
        first_dense_layers=a.first_dense_layers, capacity_factor=a.capacity_factor,
        tie_embeddings=a.tie_embeddings, norm_eps=a.norm_eps, rope_theta=a.rope_theta,
        act=a.act, vocab_pad_multiple=a.vocab_pad_multiple)


def param_name(a: Arch, kind: str, index: "int | None") -> str:
    """The decoder's parameter of one leaf (`weights.leaves`)."""
    if kind in ("tok", "unembed"):
        return f"embed.{kind}"
    if kind == "final_norm":
        return kind
    if kind in ("norm1", "norm2"):
        return f"layers.{index}.{kind}"
    if kind in ("wq", "wk", "wv", "wo"):
        return f"layers.{index}.attn.{kind}"
    if kind in ("w_gate", "w_up", "w_down"):
        return f"layers.{index}.mlp.{kind}"
    return f"layers.{a.dense_layers + index}.moe.{kind}"


@torch.no_grad()
def load(model, a, seed: int, dtype: torch.dtype, tok_scale: float = 1.0) -> None:
    """Copy the benchmark's draw (`weights.draw`) into the program's params,
    one stacked kind at a time."""
    mod = arch.module(a)
    name = mod.param_name
    for kind, t in weights.draw(a, seed, model.device, dtype, tok_scale):
        if kind in mod.GLOBAL:
            model.get_parameter(name(a, kind, None)).copy_(t)
        else:
            for i in range(t.shape[0]):
                model.get_parameter(name(a, kind, i)).copy_(t[i])
        del t


def build(a, device, param_dtype: torch.dtype, chunk: int):
    """The port's `Model` on ``device`` (params allocated, not drawn), with the
    launchers' `ParallelConfig` (remat of each block, ``"block"``)."""
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import Model

    return Model(arch.module(a).model_config(a), ParallelConfig(), q_chunk=chunk, kv_chunk=chunk,
                 device=device, param_dtype=param_dtype)
