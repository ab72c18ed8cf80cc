"""Model / parallelism / shape configuration dataclasses."""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention details
    qkv_bias: bool = False
    window: int = 0  # local-attention window (0 = n/a)
    # per-layer block pattern, cycled over n_layers:
    #   "attn" (global), "local", "ssm" (mamba2), "rglru" (griffin block),
    #   "mla" (multi-head latent attention, DeepSeek-V2/V3)
    pattern: tuple[str, ...] = ("attn",)
    logit_softcap: float = 0.0
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # multi-head latent attention ("mla" layers): q is one projection to
    # n_heads x (qk_nope_head_dim + qk_rope_head_dim); keys and values come
    # from a normed latent of kv_lora_rank and one rotary key of
    # qk_rope_head_dim shared by every head
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # the router: "softmax" probabilities, or "sigmoid" scores whose top-k
    # are chosen over the scores plus a per-expert bias (a ``router_bias``
    # leaf) and whose gates are the chosen scores renormalized; the gates
    # times ``routed_scale``
    router_scoring: str = "softmax"
    routed_scale: float = 1.0

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    d_inner: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssm_chunk: int = 256

    # RG-LRU (recurrentgemma)
    lru_width: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0  # precomputed frame embeddings (frontend stub)

    # vlm
    n_patches: int = 0  # precomputed patch embeddings prepended (stub)

    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"
    # Pad the vocab so the embedding shards over the model axis (Megatron-
    # style).  Padded logit rows are masked to -inf in unembed, so semantics
    # are unchanged.  1 disables padding (smoke tests).
    vocab_pad_multiple: int = 2048

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        m = max(1, self.vocab_pad_multiple)
        return -(-self.vocab_size // m) * m
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer block kind, pattern cycled over n_layers."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Approximate parameter count (reporting / roofline)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for i, kind in enumerate(self.layer_kinds):
            if kind == "mla":
                total += self._mla_params() + self._layer_ffn_params(d, i)
            elif kind in ("attn", "local"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)  # qkv
                total += self.n_heads * hd * d  # o
                total += self._ffn_params(d)
            elif kind == "ssm":
                di = self.d_inner or 2 * d
                nh = di // self.ssm_head_dim
                total += d * (2 * di + 2 * self.ssm_state + nh)  # in_proj-ish
                total += di * d  # out
            elif kind == "rglru":
                w = self.lru_width or d
                total += d * w * 2 + w * d + w * 3  # gates + proj
                total += self._ffn_params(d)
            total += 2 * d  # norms
        return total

    def _mla_params(self) -> int:
        """An ``mla`` layer's attention: q, the latent and rotary key, the
        latent's norm, its expansion to keys and values, and o."""
        d, h, r = self.d_model, self.n_heads, self.kv_lora_rank
        dn, dr, dv = self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim
        return d * h * (dn + dr) + d * (r + dr) + r + r * h * (dn + dv) + h * dv * d

    def _layer_ffn_params(self, d: int, layer: int) -> int:
        """Layer ``layer``'s FFN: dense before ``first_dense_layers`` (or in a
        dense model), else the MoE with the router's bias."""
        if self.is_moe and layer >= self.first_dense_layers:
            bias = self.n_experts if self.router_scoring == "sigmoid" else 0
            return self._ffn_params(d) + bias
        return 3 * d * self.d_ff

    def _ffn_params(self, d: int) -> int:
        if self.is_moe:
            e_ff = self.moe_d_ff
            routed = self.n_experts * 3 * d * e_ff
            shared = self.n_shared_experts * 3 * d * e_ff
            router = d * self.n_experts
            return routed + shared + router
        return 3 * d * self.d_ff  # gate/up/down

    def n_active_params(self) -> int:
        """Active params per token (MoE-aware) — used for MODEL_FLOPS."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        e_ff = self.moe_d_ff
        full = self.n_params()
        routed_all = 0
        routed_active = 0
        for i, kind in enumerate(self.layer_kinds):
            if kind in ("attn", "local") or (kind == "mla" and i >= self.first_dense_layers):
                routed_all += self.n_experts * 3 * d * e_ff
                routed_active += self.top_k * 3 * d * e_ff
        return full - routed_all + routed_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How to map the model onto the mesh (the TPU 'topology' axis of the
    paper's Algorithm-I search space — core/mesh_explorer.py sweeps these)."""

    # Mesh axis names, outermost first.  ("data", "model") single pod,
    # ("pod", "data", "model") multi-pod.
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp: bool = True  # shard params/opt-state over data axes
    seq_shard_kv: bool = True  # shard decode KV seq over model if heads don't divide
    remat: str = "block"  # none | block | full
    grad_accum: int = 1
    # gradient compression for the DP all-reduce: none | bf16 | int8_ef
    grad_compression: str = "none"
    # scan layers (compile-time/memory win) — turned off for tiny tests
    scan_layers: bool = True

    @property
    def all_data_axes(self) -> tuple[str, ...]:
        return self.data_axes
