"""Plain float32 reference of the benchmark's latent-attention models
(``"arch": "mla"``: DeepSeek-V3's block as Moonlight-16B-A3B publishes
it), written from the configuration file and not from the program.

The block is pre-norm.  Multi-head latent attention with q uncompressed:
``q = x W_q``, each head's part without positions (``qk_nope_head_dim``)
and its rotary part (``qk_rope_head_dim``); ``[c, k_r] = x W_kva``, the
latent ``c`` RMS-normed; each head's nope key and its value from ``c
W_kvb``; RoPE on q's rotary part and on ``k_r``, one rotary key that every
head shares; causal softmax attention over every earlier position (left
pads included: they hold the first positions) with scale ``1 / sqrt(nope
+ rope)``; the heads' values through ``W_o``.  This is the attention not
absorbed: the program's decode takes W_UK into the query and W_UV after
the sum, which computes the same function.  A SiLU-gated FFN in the
first ``first_dense_layers`` layers, then an MoE: sigmoid scores, the top
``top_k`` of the scores plus the per-expert selection bias (the lower
index first on ties), gates the chosen scores over their sum times
``routed_scale``, plus the shared experts.  A final norm and an untied
head (the embedding table's transpose where tied).

Departures from the published model (the program's too):

- rotary halves: the first and second halves of a rotary part rotate
  together, where DeepSeek-V3 rotates interleaved pairs.  With random
  weights the two differ by a fixed permutation of the rotary columns of
  ``W_q`` and ``W_kva``, so the model class is the same;
- a norm's gain is ``1 + g``, with ``g`` drawn;
- the embedding is scaled by ``sqrt(d_model)``, as the port scales every
  model's;
- capacity drops: an expert keeps its first ``capacity`` assignments of a
  routing group in token order and drops the rest (the published model
  drops nothing).  A routing group is what the served path routes at
  once: the whole padded prompt batch at prefill, then the batch's tokens
  of one position at each decode step;
- training: the published model moves the selection bias by a rule
  outside the gradient and adds a sequence-wise balance loss; the program
  has a Switch-style loss over the per-token normalised scores instead
  (train only), and this reference computes no balance loss;
- no ``rope_scaling`` (the configuration gives none).

Weights come as the stacked kinds of `portbench.weights` (any dtype; each
is read in float32, one matmul at a time).  ``lowp`` rounds both operands
of every matmul through float8 e4m3 with one scale a tensor: the control
of the correctness check.  ``replay`` (a `Replay`) hands every MoE layer
the experts another run chose, in place of its own top k, and counts the
choices its own scores would not have made; an empty one records the
choices made.  TF32 is off.  The attention and the dense FFN
run in blocks of rows and the shared experts in blocks of tokens, so that
at the served shapes (256 rows of 895 tokens) the working set stays a few
GB beside the weights.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch
import torch.utils.checkpoint

from . import decoder as D

if TYPE_CHECKING:
    from ..archs.mla import MLA

#: the float32 bytes one block of rows (or tokens) may hold at once
BLOCK_BYTES = 4 << 30


def _blocks(n: int, bytes_each: int):
    step = max(1, min(n, BLOCK_BYTES // max(1, bytes_each)))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def attention(a: MLA, W: dict, i: int, h: torch.Tensor, lowp: bool) -> torch.Tensor:
    b, t, _ = h.shape
    H, r = a.n_heads, a.kv_lora_rank
    dn, dr, dv = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    outs = []
    for lo, hi in _blocks(b, 3 * H * t * t * 4):  # the scores, their mask and softmax
        x, n = h[lo:hi], hi - lo
        q = D.mm(x, W["wq"][i], lowp).view(n, t, H, dn + dr)
        ckr = D.mm(x, W["wkv_a"][i], lowp)
        c = D.rms_norm(ckr[..., :r], W["kv_norm"][i], a.norm_eps)
        k_r = D.rope(ckr[:, :, None, r:], a.rope_theta)  # (n, t, 1, rope)
        q = torch.cat([q[..., :dn], D.rope(q[..., dn:], a.rope_theta)], -1)
        kv = D.mm(c, W["wkv_b"][i], lowp).view(n, t, H, dn + dv)
        k = torch.cat([kv[..., :dn], k_r.expand(n, t, H, dr)], -1)
        q, k, v = (z.transpose(1, 2) for z in (q, k, kv[..., dn:]))  # (n, H, t, .)
        s = D.mm(q, k.transpose(-1, -2), lowp) / math.sqrt(dn + dr)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = D.mm(p, v, lowp).transpose(1, 2).reshape(n, t, H * dv)
        outs.append(D.mm(o, W["wo"][i], lowp))
    return torch.cat(outs)


def dense_ffn(a: MLA, W: dict, j: int, h: torch.Tensor, lowp: bool) -> torch.Tensor:
    b, t, _ = h.shape
    return torch.cat([D.dense_ffn(a, W, j, h[lo:hi], lowp)
                      for lo, hi in _blocks(b, 3 * t * a.d_ff * 4)])


def route(a: MLA, W: dict, j: int, x: torch.Tensor, lowp: bool,
          given: "torch.Tensor | None" = None):
    """x: (N, D) -> (experts (N, k), gates (N, k), own (N, k)): the top k of
    the sigmoid scores plus the selection bias (``own``; the experts unless
    ``given``), gated by the unbiased scores of the experts."""
    s = torch.sigmoid(D.mm(x, W["router"][j], lowp))
    choice = s + W["router_bias"][j].float()
    own = torch.sort(choice, dim=-1, descending=True, stable=True).indices[:, : a.top_k]
    expert = own if given is None else given.to(x.device, torch.long)
    gate = s.gather(-1, expert)
    return expert, gate / gate.sum(-1, keepdim=True) * a.routed_scale, own


class Replay:
    """Expert choices across a `served_logits` run, keyed by ``(MoE layer,
    part)`` (part 0 the prompt batch, 1 the decode steps', position-major,
    as `moe_ffn` lays them out), each (N, k).

    With ``given``, each layer takes those choices in place of its own and
    counts, in ``missed``, each given choice that is not among its own top
    k (of ``assigned`` in all); without, it records its own in ``taken``."""

    def __init__(self, given: "dict | None" = None):
        self.given = given
        self.taken: dict = {}
        self.missed = self.assigned = 0

    def miss_pct(self) -> float:
        return 100.0 * self.missed / max(1, self.assigned)


def shared_experts(a: MLA, W: dict, j: int, x: torch.Tensor, lowp: bool) -> torch.Tensor:
    fs = a.moe_d_ff * a.n_shared_experts
    return torch.cat([
        D.mm(D.act(a, D.mm(x[lo:hi], W["ws_gate"][j], lowp)) * D.mm(x[lo:hi], W["ws_up"][j], lowp),
             W["ws_down"][j], lowp)
        for lo, hi in _blocks(x.shape[0], 3 * fs * 4)])


def moe_ffn(a: MLA, W: dict, j: int, h: torch.Tensor, prompt_len: int,
            lowp: bool, replay: "Replay | None" = None) -> torch.Tensor:
    """h: (B, T, D).  Positions below ``prompt_len`` are one routing group
    (batch-major); each later position is a group of the batch's tokens."""
    b, t, d = h.shape
    p = prompt_len
    parts = [(h[:, :p].reshape(b * p, d), 1)]
    if t > p:
        parts.append((h[:, p:].transpose(0, 1).reshape((t - p) * b, d), t - p))
    outs = []
    for part, (x, groups) in enumerate(parts):
        given = replay.given[(j, part)] if replay is not None and replay.given else None
        expert, gate, own = route(a, W, j, x, lowp, given)
        if replay is not None and given is None:
            replay.taken[(j, part)] = own
        elif replay is not None:
            replay.missed += int((expert[:, :, None] != own[:, None, :]).all(-1).sum())
            replay.assigned += expert.numel()
        w = torch.where(D.kept(a, expert, groups), gate, 0.0)
        y = torch.zeros_like(x)
        for e in range(a.n_experts):
            tok, slot = (expert == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = x[tok]
            he = D.act(a, D.mm(xe, W["we_gate"][j, e], lowp)) * D.mm(xe, W["we_up"][j, e], lowp)
            y.index_add_(0, tok, D.mm(he, W["we_down"][j, e], lowp) * w[tok, slot, None])
        if a.n_shared_experts:
            y = y + shared_experts(a, W, j, x, lowp)
        outs.append(y)
    out = outs[0].view(b, p, d)
    if t > p:
        out = torch.cat([out, outs[1].view(t - p, b, d).transpose(0, 1)], dim=1)
    return out


def block(a: MLA, W: dict, i: int, x: torch.Tensor, prompt_len: int, lowp: bool,
          replay: "Replay | None" = None):
    x = x + attention(a, W, i, D.rms_norm(x, W["norm1"][i], a.norm_eps), lowp)
    h = D.rms_norm(x, W["norm2"][i], a.norm_eps)
    if i < a.dense_layers:
        return x + dense_ffn(a, W, i, h, lowp)
    return x + moe_ffn(a, W, i - a.dense_layers, h, prompt_len, lowp, replay)


def unembed(a: MLA, W: dict, x: torch.Tensor, lowp: bool) -> torch.Tensor:
    """Logits over the real vocabulary (float32)."""
    return D.unembed(a, W, x, lowp)


def hidden(a: MLA, W: dict, tokens: torch.Tensor, prompt_len: int | None = None,
           lowp: bool = False, checkpoint: bool = False,
           replay: "Replay | None" = None) -> torch.Tensor:
    """The residual stream after the last block, (B, T, D) float32.
    ``prompt_len`` (MoE only) splits the routing groups as served; None
    routes all tokens as one group.  ``checkpoint`` recomputes each block
    in the backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = tokens.shape[1] if prompt_len is None else prompt_len
    x = D.embed(a, W, tokens)
    for i in range(a.n_layers):
        if checkpoint and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(block, a, W, i, x, p, lowp, use_reentrant=False)
        else:
            x = block(a, W, i, x, p, lowp, replay)
    return x


def served_logits(a: MLA, W: dict, tokens: torch.Tensor, prompt_len: int,
                  lowp: bool = False, replay: "Replay | None" = None) -> torch.Tensor:
    """tokens: (B, T), the padded prompts then the tokens fed back at each
    decode step.  Returns the logits that chose each output token: (B, T -
    prompt_len + 1, V), at positions prompt_len - 1 .. T - 1."""
    x = hidden(a, W, tokens, prompt_len, lowp, replay=replay)[:, prompt_len - 1:].clone()
    return unembed(a, W, x, lowp)
