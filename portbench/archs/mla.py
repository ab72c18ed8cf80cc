"""Multi-head latent attention (DeepSeek-V3's block, as Moonlight-16B-A3B
publishes it): q one projection (no ``q_lora_rank``), keys and values
from a normed latent of ``kv_lora_rank`` and one rotary key every head
shares; a dense FFN in the first ``first_k_dense_replace`` layers, then
an MoE whose sigmoid router picks the top ``num_experts_per_tok`` of
``n_routed_experts`` by score plus a per-expert selection bias
(``noaux_tc`` with one group), gates the chosen scores renormalized
times ``routed_scaling_factor``, beside ``n_shared_experts`` shared
experts; an untied head.  It reads every configuration file whose
``"arch"`` is ``"mla"`` (`arch` lists what an architecture provides).

The counts follow the program: prefill and training run the attention
not absorbed (each head's nope key and value expanded from the latent,
causal attention over (nope + rope)-wide keys and ``v_head_dim``-wide
values), decode absorbed (the nope query taken into the latent space
through W_UK, scores over the latent and the rotary key of each attended
slot, the weighted sum of latents, then W_UV).  The absorbed step's
weights are the same matrices, so a token passes through the same
number of matmul weights either way.
"""

from __future__ import annotations

import dataclasses
import math

GLOBAL = ("tok", "final_norm", "unembed")
#: bytes of one latent slot's element (the program's bfloat16 cache)
LATENT_BYTES = 2


@dataclasses.dataclass(frozen=True)
class MLA:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    d_ff: int  # the dense FFN's width (the leading layers of an MoE, every layer of a dense one)
    vocab_size: int
    vocab_pad_multiple: int
    tie_embeddings: bool
    norm_eps: float
    rope_theta: float
    act: str
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    routed_scale: float = 1.0
    bias_std: float = 0.0  # the std of the drawn selection bias
    arch: str = "mla"

    @property
    def head_dim(self) -> int:
        """A query's and a key's width in a head (nope + rope)."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_width(self) -> int:
        """One cache slot: the latent and the rotary key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def padded_vocab(self) -> int:
        m = max(1, self.vocab_pad_multiple)
        return -(-self.vocab_size // m) * m

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def dense_layers(self) -> int:
        return self.first_dense_layers if self.is_moe else self.n_layers

    @property
    def moe_layers(self) -> int:
        return self.n_layers - self.dense_layers if self.is_moe else 0

    def capacity(self, n_tokens: int) -> int:
        """Slots an expert has in a routing group of ``n_tokens`` tokens."""
        cap = int(math.ceil(n_tokens * self.top_k / self.n_experts * self.capacity_factor))
        return min(max(cap, 8), n_tokens * self.top_k)


#: the latent widths, given all together
WIDTHS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim")
#: the published settings the program runs, and only these
RUNS = dict(q_lora_rank=None, scoring_func="sigmoid", topk_method="noaux_tc", n_group=1,
            topk_group=1, norm_topk_prob=True, moe_layer_freq=1, attention_bias=False)


def from_dict(c: dict) -> MLA:
    """The published keys (Hugging Face names of ``deepseek_v3``) of a
    configuration file; ``router_bias_std`` is the benchmark's (the
    drawn selection bias).  A setting the program does not run is
    refused, and so is a file that gives some of the four latent widths
    and not all.  A file that gives none of them (a decoder's, as the
    architecture contract's test feeds every module) takes the
    DeepSeek-V2/V3 family's ratios to its head width (nope and value one
    head width, rope half of it, the latent four)."""
    for k, v in RUNS.items():
        if k in c and c[k] != v:
            raise ValueError(f"{c['name']}: {k}={c[k]!r}; the port runs {k}={v!r} only")
    missing = [k for k in WIDTHS if k not in c]
    if missing and len(missing) < len(WIDTHS):
        raise ValueError(f"{c['name']}: no {', '.join(missing)}; an mla file gives all of "
                         f"{', '.join(WIDTHS)}")
    hd = int(c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"])
    n_exp = int(c.get("n_routed_experts") or 0)
    return MLA(
        name=c["name"],
        n_layers=int(c["num_hidden_layers"]),
        d_model=int(c["hidden_size"]),
        n_heads=int(c["num_attention_heads"]),
        kv_lora_rank=int(c.get("kv_lora_rank", 4 * hd)),
        qk_nope_head_dim=int(c.get("qk_nope_head_dim", hd)),
        qk_rope_head_dim=int(c.get("qk_rope_head_dim", hd // 2)),
        v_head_dim=int(c.get("v_head_dim", hd)),
        d_ff=int(c["intermediate_size"]),
        vocab_size=int(c["vocab_size"]),
        vocab_pad_multiple=int(c.get("vocab_pad_multiple", 1)),
        tie_embeddings=bool(c["tie_word_embeddings"]),
        norm_eps=float(c["rms_norm_eps"]),
        rope_theta=float(c["rope_theta"]),
        act=c["hidden_act"],
        n_experts=n_exp,
        n_shared_experts=int(c.get("n_shared_experts") or 0),
        top_k=int(c.get("num_experts_per_tok") or 0),
        moe_d_ff=int(c.get("moe_intermediate_size") or 0),
        first_dense_layers=int(c.get("first_k_dense_replace") or 0),
        capacity_factor=float(c.get("capacity_factor", 1.25)),
        routed_scale=float(c.get("routed_scaling_factor", 1.0)),
        bias_std=float(c.get("router_bias_std", 0.0)),
        arch=c.get("arch", "mla"),
    )


def kinds(a: MLA, tok_scale: float = 1.0) -> list[tuple[str, tuple[int, ...], float]]:
    """``(kind, stacked shape, std)`` of every kind of leaf, in draw order
    (`weights`: matrices N(0, 1 / fan_in), norm gains N(0, 0.1) applied as
    ``1 + g``, the selection bias N(0, ``bias_std``))."""
    d, L, h, r = a.d_model, a.n_layers, a.n_heads, a.kv_lora_rank
    dn, dr, dv = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    out = [
        ("tok", (a.padded_vocab, d), tok_scale / math.sqrt(d)),
        ("final_norm", (d,), 0.1),
        ("norm1", (L, d), 0.1),
        ("norm2", (L, d), 0.1),
        ("wq", (L, d, h * (dn + dr)), 1 / math.sqrt(d)),
        ("wkv_a", (L, d, r + dr), 1 / math.sqrt(d)),
        ("kv_norm", (L, r), 0.1),
        ("wkv_b", (L, r, h * (dn + dv)), 1 / math.sqrt(r)),
        ("wo", (L, h * dv, d), 1 / math.sqrt(h * dv)),
    ]
    ld, f = a.dense_layers, a.d_ff
    if ld:
        out += [("w_gate", (ld, d, f), 1 / math.sqrt(d)),
                ("w_up", (ld, d, f), 1 / math.sqrt(d)),
                ("w_down", (ld, f, d), 1 / math.sqrt(f))]
    lm, e, fe = a.moe_layers, a.n_experts, a.moe_d_ff
    if lm:
        out += [("router", (lm, d, e), 1 / math.sqrt(d)),
                ("router_bias", (lm, e), a.bias_std),
                ("we_gate", (lm, e, d, fe), 1 / math.sqrt(d)),
                ("we_up", (lm, e, d, fe), 1 / math.sqrt(d)),
                ("we_down", (lm, e, fe, d), 1 / math.sqrt(fe))]
        if a.n_shared_experts:
            fs = fe * a.n_shared_experts
            out += [("ws_gate", (lm, d, fs), 1 / math.sqrt(d)),
                    ("ws_up", (lm, d, fs), 1 / math.sqrt(d)),
                    ("ws_down", (lm, fs, d), 1 / math.sqrt(fs))]
    if not a.tie_embeddings:
        out.append(("unembed", (d, a.padded_vocab), 1 / math.sqrt(d)))
    return out


def model_config(a: MLA):
    """The port's ``ModelConfig``: ``mla`` layers, the sigmoid router with
    its bias and scale.  A program without latent attention is refused."""
    from repro_torch.models.config import ModelConfig

    if "kv_lora_rank" not in {f.name for f in dataclasses.fields(ModelConfig)}:
        raise RuntimeError(f"{a.name}: this program has no latent attention "
                           f"(its ModelConfig has no kv_lora_rank)")
    return ModelConfig(
        name=a.name, family="moe" if a.is_moe else "dense", n_layers=a.n_layers,
        d_model=a.d_model, n_heads=a.n_heads, n_kv_heads=a.n_heads, head_dim=a.head_dim,
        d_ff=a.d_ff, vocab_size=a.vocab_size, pattern=("mla",), kv_lora_rank=a.kv_lora_rank,
        qk_nope_head_dim=a.qk_nope_head_dim, qk_rope_head_dim=a.qk_rope_head_dim,
        v_head_dim=a.v_head_dim, n_experts=a.n_experts, n_shared_experts=a.n_shared_experts,
        top_k=a.top_k, moe_d_ff=a.moe_d_ff, first_dense_layers=a.first_dense_layers,
        capacity_factor=a.capacity_factor, router_scoring="sigmoid", routed_scale=a.routed_scale,
        tie_embeddings=a.tie_embeddings, norm_eps=a.norm_eps, rope_theta=a.rope_theta,
        act=a.act, vocab_pad_multiple=a.vocab_pad_multiple)


def param_name(a: MLA, kind: str, index: "int | None") -> str:
    """The program's parameter of one leaf (`weights.leaves`)."""
    if kind in ("tok", "unembed"):
        return f"embed.{kind}"
    if kind == "final_norm":
        return kind
    if kind in ("norm1", "norm2"):
        return f"layers.{index}.{kind}"
    if kind in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo"):
        return f"layers.{index}.attn.{kind}"
    if kind in ("w_gate", "w_up", "w_down"):
        return f"layers.{index}.mlp.{kind}"
    return f"layers.{a.dense_layers + index}.moe.{kind}"


# -- counts (the signatures of `counts`) ------------------------------------


def attn_params(a: MLA) -> int:
    """Matmul weights of a layer's attention: q, the latent and rotary key,
    W_UK and W_UV (``wkv_b``), o."""
    d, h, r = a.d_model, a.n_heads, a.kv_lora_rank
    return (d * h * a.head_dim + d * a.latent_width
            + r * h * (a.qk_nope_head_dim + a.v_head_dim) + h * a.v_head_dim * d)


def ffn_params_active(a: MLA, layer: int) -> int:
    """Matmul weights one token passes through in a layer's FFN."""
    d = a.d_model
    if layer < a.dense_layers:
        return 3 * d * a.d_ff
    return d * a.n_experts + 3 * d * a.moe_d_ff * (a.top_k + a.n_shared_experts)


def token_matmul_params(a: MLA) -> int:
    return sum(attn_params(a) + ffn_params_active(a, i) for i in range(a.n_layers))


def causal_attn_flops(a: MLA, seq: int) -> int:
    """Not absorbed: a causal sequence, position p attending p + 1, scores
    over (nope + rope) and the sum of ``v_head_dim``-wide values."""
    return (a.n_layers * a.n_heads * 2 * (a.head_dim + a.v_head_dim)
            * seq * (seq + 1) // 2)


def latent_attn_flops(a: MLA, attended: int) -> int:
    """Absorbed: one query over ``attended`` slots in every layer, scores
    over the latent and the rotary key, the weighted sum of latents."""
    return a.n_layers * a.n_heads * 2 * (a.latent_width + a.kv_lora_rank) * attended


def prefill_flops(a: MLA, batch: int, seq: int) -> int:
    per_row = (2 * token_matmul_params(a) * seq + causal_attn_flops(a, seq)
               + 2 * a.d_model * a.vocab_size)
    return batch * per_row


def decode_flops(a: MLA, batch: int, attended: int) -> int:
    return batch * (2 * token_matmul_params(a) + latent_attn_flops(a, attended)
                    + 2 * a.d_model * a.vocab_size)


def latent_bytes(a: MLA, batch: int, attended: int, layers: "int | None" = None) -> int:
    """The latent slots ``batch`` rows attend, ``attended`` each, read once in
    ``layers`` layers (all of them by default)."""
    n = a.n_layers if layers is None else layers
    return n * batch * attended * a.latent_width * LATENT_BYTES


def decode_bytes(a: MLA, batch: int, attended: int, experts_hit: "float | None" = None,
                 wbytes: int = 2, kvbytes: int = LATENT_BYTES, logit_bytes: int = 2) -> float:
    """One decode step: each layer's weights once (an MoE layer's router,
    its fp32 selection bias, the shared experts and the routed experts its
    tokens reach: ``experts_hit`` on average over the MoE layers, None for
    all), the final norm and the head, the embedding rows looked up, the
    attended latent slots and the step's new ones, and the logits."""
    d, r = a.d_model, a.kv_lora_rank
    w = a.n_layers * (attn_params(a) + r + 2 * d) + d  # attention, the norms, the final norm
    w += a.dense_layers * 3 * d * a.d_ff
    bias = 0
    if a.moe_layers:
        hit = a.n_experts if experts_hit is None else experts_hit
        w += a.moe_layers * (d * a.n_experts + 3 * d * a.moe_d_ff * (hit + a.n_shared_experts))
        bias = a.moe_layers * a.n_experts * 4
    w += d * a.vocab_size
    slot = a.n_layers * a.latent_width * kvbytes
    return (w * wbytes + bias + batch * d * wbytes + batch * attended * slot + batch * slot
            + batch * a.vocab_size * logit_bytes)


def train_flops(a: MLA, batch: int, seq: int) -> int:
    """Forward and backward (three times the forward), not absorbed."""
    fwd = 2 * (token_matmul_params(a) + a.d_model * a.vocab_size) * seq + causal_attn_flops(a, seq)
    return 3 * batch * fwd
