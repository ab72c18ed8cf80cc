"""Operations and bytes a step needs, from the configuration and the shapes.

What the work needs, whatever computes it: attention over the positions a
query attends (causal), an MoE token through its ``top_k`` routed experts
and the shared ones, a decode step's weights read once (for an MoE layer
only the experts its tokens route to), the cached keys and values it
attends read once, its new keys and values written once, and its logits
written once.  Masked blocks, idle capacity slots and padded vocabulary
rows that the program computes anyway are not counted.  The rooflines and
utilizations of every later kernel read these counts.

The peaks and `least_seconds` are every architecture's; the rest is the
decoder's (`archs/decoder.py`).  A reader asks the architecture of the
record's numbers for its counts (`arch.module`), with these signatures.
"""

from __future__ import annotations

from .arch import Arch

#: published peaks of one NVIDIA H100 SXM (data sheet, dense rates)
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of its two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def attn_params(a: Arch) -> int:
    d, hd = a.d_model, a.head_dim
    return d * hd * (a.n_heads + 2 * a.n_kv_heads) + a.n_heads * hd * d


def ffn_params_active(a: Arch, layer: int) -> int:
    """Matmul weights one token passes through in a layer's FFN."""
    d = a.d_model
    if layer < a.dense_layers:
        return 3 * d * a.d_ff
    return d * a.n_experts + 3 * d * a.moe_d_ff * (a.top_k + a.n_shared_experts)


def token_matmul_params(a: Arch) -> int:
    """Matmul weights one token passes through in the blocks (unembedding apart)."""
    return sum(attn_params(a) + ffn_params_active(a, i) for i in range(a.n_layers))


def attn_flops(a: Arch, attended: int) -> int:
    """One query over ``attended`` positions in every layer: scores and the
    weighted sum of values."""
    return a.n_layers * a.n_heads * 4 * a.head_dim * attended


def causal_attn_flops(a: Arch, seq: int) -> int:
    """A causal sequence of ``seq`` queries, position p attending p + 1."""
    return a.n_layers * a.n_heads * 4 * a.head_dim * seq * (seq + 1) // 2


def prefill_flops(a: Arch, batch: int, seq: int) -> int:
    """A padded prompt batch: every position through the blocks, logits of
    the last one."""
    per_row = (2 * token_matmul_params(a) * seq + causal_attn_flops(a, seq)
               + 2 * a.d_model * a.vocab_size)
    return batch * per_row


def decode_flops(a: Arch, batch: int, attended: int) -> int:
    """One decode step: ``batch`` tokens, each attending ``attended`` positions
    (its own included), and their logits."""
    return batch * (2 * token_matmul_params(a) + attn_flops(a, attended)
                    + 2 * a.d_model * a.vocab_size)


def decode_bytes(a: Arch, batch: int, attended: int, experts_hit: "float | None" = None,
                 wbytes: int = 2, kvbytes: int = 2, logit_bytes: int = 2) -> float:
    """One decode step.  ``experts_hit``: routed experts its tokens reach in
    a layer, on average over the MoE layers (None: every expert)."""
    d, hd = a.d_model, a.head_dim
    w = a.n_layers * (attn_params(a) + 2 * d) + d  # attention, the norms, the final norm
    w += a.dense_layers * 3 * d * a.d_ff
    if a.moe_layers:
        hit = a.n_experts if experts_hit is None else experts_hit
        w += a.moe_layers * (d * a.n_experts
                             + 3 * d * a.moe_d_ff * (hit + a.n_shared_experts))
    w += d * a.vocab_size  # the unembedding (the embedding's rows are the batch's, below)
    kv_row = a.n_layers * 2 * a.n_kv_heads * hd * kvbytes  # one position's keys and values
    return (w * wbytes + batch * d * wbytes  # the weights, the embedding rows looked up
            + batch * attended * kv_row  # the cache it attends
            + batch * kv_row  # the new keys and values
            + batch * a.vocab_size * logit_bytes)


def train_flops(a: Arch, batch: int, seq: int) -> int:
    """Forward and backward (three times the forward) of ``batch`` causal
    sequences: every matmul weight, the unembedding, and attention over the
    attended positions.  Recomputation is not counted."""
    fwd = 2 * (token_matmul_params(a) + a.d_model * a.vocab_size) * seq + causal_attn_flops(a, seq)
    return 3 * batch * fwd
