"""Plain float32 reference of the benchmark's decoders, written from the
configuration file and not from the program.

The block is a pre-norm decoder: RMS norm with gain ``1 + g``, rotary
positions on the first and second halves of each head, causal softmax
attention over every earlier position (left pads included: they hold the
first positions), a SiLU-gated FFN, a final norm and the unembedding (the
embedding table's transpose when tied), the embedding scaled by
``sqrt(d_model)``.  An MoE layer routes each token to its ``top_k`` experts
by softmax probability, renormalised over the chosen ones when the
configuration says so, keeps an expert's first ``capacity`` assignments of
a routing group in token order and drops the rest, and adds the shared
experts.  A routing group is what the served path routes at once: the
whole padded prompt batch at prefill, then the batch's tokens of one
position at each decode step.

Weights come as the stacked kinds of `portbench.weights` (any dtype; each
is read in float32).  ``lowp`` rounds both operands of every matmul
through float8 e4m3 with one scale a tensor: the control of the
correctness check, one precision below the bfloat16 the program states.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

if TYPE_CHECKING:
    from ..arch import Arch


def _q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 (largest finite 448) with a per-tensor
    scale, as a straight-through value (its gradient is the identity)."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    x, w = x.float(), w.float()
    if lowp:
        x, w = _q8(x), _q8(w)
    return x @ w


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + g.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, D) at positions 0..T-1."""
    t, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv  # (T, D/2)
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[None, :, None, :]
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def act(a: Arch, x: torch.Tensor) -> torch.Tensor:
    if a.act == "silu":
        return F.silu(x)
    if a.act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(a.act)


def attention(a: Arch, W: dict, i: int, h: torch.Tensor, lowp: bool) -> torch.Tensor:
    b, t, _ = h.shape
    hd = a.head_dim
    q = mm(h, W["wq"][i], lowp).view(b, t, a.n_heads, hd)
    k = mm(h, W["wk"][i], lowp).view(b, t, a.n_kv_heads, hd)
    v = mm(h, W["wv"][i], lowp).view(b, t, a.n_kv_heads, hd)
    q, k = rope(q, a.rope_theta), rope(k, a.rope_theta)
    rep = a.n_heads // a.n_kv_heads
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))  # (B, H, T, D)
    s = mm(q, k.transpose(-1, -2), lowp) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(p, v, lowp).transpose(1, 2).reshape(b, t, a.n_heads * hd)
    return mm(o, W["wo"][i], lowp)


def dense_ffn(a: Arch, W: dict, j: int, h: torch.Tensor, lowp: bool) -> torch.Tensor:
    return mm(act(a, mm(h, W["w_gate"][j], lowp)) * mm(h, W["w_up"][j], lowp),
              W["w_down"][j], lowp)


def route(a: Arch, router: torch.Tensor, x: torch.Tensor, lowp: bool):
    """x: (N, D) -> (experts (N, k), gates (N, k)) by softmax probability."""
    probs = torch.softmax(mm(x, router, lowp), dim=-1)
    gate, expert = probs.topk(a.top_k, dim=-1)
    if a.norm_topk_prob:
        gate = gate / gate.sum(-1, keepdim=True)
    return expert, gate


def kept(a: Arch, expert: torch.Tensor, n_groups: int) -> torch.Tensor:
    """expert: (N, k) of ``n_groups`` equal routing groups laid end to end,
    each in token order -> (N, k) bool: the assignment is among its
    expert's first ``capacity`` in its group."""
    n = expert.shape[0]
    ng = n // n_groups
    onehot = F.one_hot(expert, a.n_experts).sum(1)  # (N, E): 0 or 1
    rank = onehot.view(n_groups, ng, -1).cumsum(1).view(n, -1) - 1  # place in line at that expert
    return rank.gather(1, expert) < a.capacity(ng)


def moe_ffn(a: Arch, W: dict, j: int, h: torch.Tensor, prompt_len: int,
            lowp: bool) -> torch.Tensor:
    """h: (B, T, D).  Positions below ``prompt_len`` are one routing group
    (batch-major); each later position is a group of the batch's tokens."""
    b, t, d = h.shape
    p = prompt_len
    parts = [(h[:, :p].reshape(b * p, d), 1)]
    if t > p:
        parts.append((h[:, p:].transpose(0, 1).reshape((t - p) * b, d), t - p))
    outs = []
    for x, groups in parts:
        expert, gate = route(a, W["router"][j], x, lowp)
        keep = kept(a, expert, groups)
        w = torch.where(keep, gate, 0.0)
        y = torch.zeros_like(x)
        for e in range(a.n_experts):
            tok, slot = (expert == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = x[tok]
            he = act(a, mm(xe, W["we_gate"][j, e], lowp)) * mm(xe, W["we_up"][j, e], lowp)
            y = y.index_add(0, tok, mm(he, W["we_down"][j, e], lowp) * w[tok, slot, None])
        if a.n_shared_experts:
            y = y + mm(act(a, mm(x, W["ws_gate"][j], lowp)) * mm(x, W["ws_up"][j], lowp),
                       W["ws_down"][j], lowp)
        outs.append(y)
    out = outs[0].view(b, p, d)
    if t > p:
        out = torch.cat([out, outs[1].view(t - p, b, d).transpose(0, 1)], dim=1)
    return out


def embed(a: Arch, W: dict, tokens: torch.Tensor) -> torch.Tensor:
    return W["tok"][tokens].float() * math.sqrt(a.d_model)


def block(a: Arch, W: dict, i: int, x: torch.Tensor, prompt_len: int, lowp: bool):
    x = x + attention(a, W, i, rms_norm(x, W["norm1"][i], a.norm_eps), lowp)
    h = rms_norm(x, W["norm2"][i], a.norm_eps)
    if i < a.dense_layers:
        return x + dense_ffn(a, W, i, h, lowp)
    return x + moe_ffn(a, W, i - a.dense_layers, h, prompt_len, lowp)


def unembed(a: Arch, W: dict, x: torch.Tensor, lowp: bool) -> torch.Tensor:
    """Logits over the real vocabulary (float32)."""
    if a.tie_embeddings:
        w = W["tok"][: a.vocab_size].transpose(0, 1)
    else:
        w = W["unembed"][:, : a.vocab_size]
    return mm(rms_norm(x, W["final_norm"], a.norm_eps), w, lowp)


def hidden(a: Arch, W: dict, tokens: torch.Tensor, prompt_len: int | None = None,
           lowp: bool = False, checkpoint: bool = False) -> torch.Tensor:
    """The residual stream after the last block, (B, T, D) float32.
    ``prompt_len`` (MoE only) splits the routing groups as served; None
    routes all tokens as one group.  ``checkpoint`` recomputes each block
    in the backward (memory for training at full size)."""
    p = tokens.shape[1] if prompt_len is None else prompt_len
    x = embed(a, W, tokens)
    for i in range(a.n_layers):
        if checkpoint and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(block, a, W, i, x, p, lowp, use_reentrant=False)
        else:
            x = block(a, W, i, x, p, lowp)
    return x


def served_logits(a: Arch, W: dict, tokens: torch.Tensor, prompt_len: int,
                  lowp: bool = False) -> torch.Tensor:
    """tokens: (B, T), the padded prompts then the tokens fed back at each
    decode step.  Returns the logits that chose each output token: (B, T -
    prompt_len + 1, V), at positions prompt_len - 1 .. T - 1."""
    x = hidden(a, W, tokens, prompt_len, lowp)
    return unembed(a, W, x[:, prompt_len - 1:], lowp)
