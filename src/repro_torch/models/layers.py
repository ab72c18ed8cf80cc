"""Transformer building blocks of the port (PyTorch).

Mirrors the reference's ``models/layers.py`` function by function: param
specs, norms, rope, chunked online-softmax attention (train / prefill)
and single-token decode attention against a KV cache, the decoder's
cross-attention over encoder keys and values, the gated MLP, the
fine-grained MoE FFN (shared + routed top-k experts, sort-based dispatch
into a capacity buffer), and the (padded-vocab) embedding.

Parameters are held by `ParamTree` modules whose leaves are addressed
like the reference's param dicts (``p["wq"]``, ``"bq" in p``), so the
functions below read as the reference's do.  Precision follows the
reference: norms and rope in fp32, attention scores and the PV product
accumulated in fp32 (bf16 operands are upcast exactly, never TF32),
probabilities cast to ``v``'s dtype before the PV product, ``-1e30`` as
the mask value everywhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

#: mask value of scores and padded vocab rows (the reference's)
NEG = -1e30


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A leaf's shape, init and std multiplier; the reference's logical
    (sharding) axes are not kept."""

    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0  # stddev multiplier on fan-in init

    def std(self) -> float:
        """The reference's rule: ``fan_in = shape[0]`` for a matrix, so for
        a stacked (scanned) leaf the fan-in is the layer count."""
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return self.scale / math.sqrt(max(1, fan_in))

    def initializer(self, generator: torch.Generator) -> torch.Tensor:
        """An fp32 draw on ``generator``'s device."""
        dev = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=torch.float32, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=torch.float32, device=dev)
        t = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=dev)
        return t.mul_(self.std())


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def stack_specs(specs, n: int):
    """Prepend a scan ("layers") dim to every leaf spec."""
    if is_spec(specs):
        return dataclasses.replace(specs, shape=(n, *specs.shape))
    return {k: stack_specs(v, n) for k, v in specs.items()}


def tree_leaves(tree, prefix: str = ""):
    """``(dotted path, leaf)`` pairs of a nested dict, keys in sorted order."""
    if not isinstance(tree, Mapping):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from tree_leaves(tree[k], f"{prefix}.{k}" if prefix else k)


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: leaves are `nn.Parameter`
    (no grad until a trainer asks, `Model.train_params`), sub-dicts are
    child `ParamTree` modules, and
    ``p[name]`` / ``name in p`` address both.  Leaves are allocated (as
    zeros) in ``dtype``, except those whose dotted path from the root is in
    ``fp32``, which stay fp32."""

    def __init__(self, specs: Mapping, device: torch.device,
                 dtype: torch.dtype = torch.float32, fp32=frozenset(), prefix: str = ""):
        super().__init__()
        for k, s in specs.items():
            if is_spec(s):
                dt = torch.float32 if prefix + k in fp32 else dtype
                self.register_parameter(k, nn.Parameter(
                    torch.zeros(s.shape, dtype=dt, device=device), requires_grad=False))
            else:
                self.add_module(k, ParamTree(s, device, dtype, fp32, f"{prefix}{k}."))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# ---------------------------------------------------------------------------
# Norms / activations / rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma)).to(dt)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S); split halves, fp32 angles."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    s = dict(
        wq=ParamSpec((d, h * hd)),
        wk=ParamSpec((d, kv * hd)),
        wv=ParamSpec((d, kv * hd)),
        wo=ParamSpec((h * hd, d)),
    )
    if cfg.qkv_bias:
        s.update(
            bq=ParamSpec((h * hd,), init="zeros"),
            bk=ParamSpec((kv * hd,), init="zeros"),
            bv=ParamSpec((kv * hd,), init="zeros"),
        )
    if cfg.qk_norm:
        s.update(
            q_norm=ParamSpec((hd,), init="zeros"),
            k_norm=ParamSpec((hd,), init="zeros"),
        )
    return s


def _project_qkv(p, x, cfg, positions, theta):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(b, s, kv * n_rep, d)


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (falls back to s for primes)."""
    if s <= target:
        return s
    if s % target == 0:
        return target
    best = 1
    d = 1
    while d * d <= s:
        if s % d == 0:
            lo, hi = d, s // d
            if lo <= target:
                best = max(best, lo)
            if hi <= target:
                best = max(best, hi)
        d += 1
    return best if best >= max(8, target // 8) else s


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q @ k^T`` accumulated in fp32 (the reference's
    ``preferred_element_type=float32``): bf16 operands upcast exactly."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, H, D)  (already GQA-repeated)
    v: torch.Tensor,
    q_offset: int = 0,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    cross: bool = False,
) -> torch.Tensor:
    """Online-softmax attention over kv chunks (flash-style, eager torch).

    The reference maps over q chunks and scans over kv chunks; here the q
    chunks ride along as a batch dim and the kv chunks are the loop, with
    the same per-chunk arithmetic (masked blocks computed, as there).
    Causal masking is by absolute position (q position = q_offset + index);
    ``cross`` (queries over another sequence's keys) turns it off.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q_chunk = _pick_chunk(sq, q_chunk)
    kv_chunk = _pick_chunk(skv, kv_chunk)
    nq, nkv = sq // q_chunk, skv // kv_chunk
    scale = 1.0 / math.sqrt(d)

    qc = q.reshape(b, nq, q_chunk, h, d).permute(1, 0, 3, 2, 4) * scale  # (nq,B,H,qc,D)
    kc = k.reshape(b, nkv, kv_chunk, h, d).permute(1, 0, 3, 2, 4)  # (nkv,B,H,kc,D)
    vc = v.reshape(b, nkv, kv_chunk, h, d).permute(1, 0, 3, 2, 4)
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev).reshape(nq, q_chunk)
    kv_pos_base = torch.arange(kv_chunk, device=dev)

    m = torch.full((nq, b, h, q_chunk), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((nq, b, h, q_chunk), dtype=torch.float32, device=dev)
    acc = torch.zeros((nq, b, h, q_chunk, d), dtype=torch.float32, device=dev)
    for ki in range(nkv):
        s_ = _scores(qc, kc[ki])  # (nq,B,H,qc,kc)
        if causal and not cross:
            kv_pos = ki * kv_chunk + kv_pos_base
            diff = q_pos[:, :, None] - kv_pos[None, None, :]  # (nq,qc,kc)
            mask = diff >= 0
            if window:
                mask &= diff < window
            s_ = torch.where(mask[:, None, None], s_, NEG)
        m_new = torch.maximum(m, s_.amax(-1))
        p = torch.exp(s_ - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), vc[ki].float())
        m = m_new
    out = (acc / torch.clamp(l[..., None], min=1e-30)).to(v.dtype)
    # (nq, B, H, qc, D) -> (B, Sq, H, D)
    return out.permute(1, 0, 3, 2, 4).reshape(b, sq, h, d)


def attention_train(p, x, cfg, kind: str, theta: float, q_chunk: int = 1024,
                    kv_chunk: int = 1024):
    """Full-sequence (forward/prefill) attention for one layer.

    Returns ``(out, (k, v))`` with k, v un-repeated (B, S, KV, D): the
    prefill cache (the reference repeats and then strides back to the same
    values)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    window = cfg.window if kind == "local" else 0
    out = chunked_attention(
        q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), causal=True, window=window,
        q_chunk=q_chunk, kv_chunk=kv_chunk,
    )
    out = out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim).to(x.dtype)
    return out @ p["wo"].to(x.dtype), (k, v)


def attention_decode(p, x, cfg, kind: str, theta: float, cache: dict, pos: int):
    """Single-token decode against a KV cache, updated in place.

    cache: dict(k=(B, S_cache, KV, D), v=...);  pos: the current index, a
    host int (one for the whole batch), so nothing here syncs.  Local
    layers use a ring cache of size ``window`` -- positions are mapped
    modulo the ring."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    dev = x.device
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, theta)

    s_cache = cache["k"].shape[1]
    is_ring = kind == "local" and cfg.window and cfg.window < 10**9 and s_cache <= cfg.window
    slot = pos % s_cache if is_ring else pos
    k, v = cache["k"], cache["v"]
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)

    n_rep = cfg.n_heads // cfg.n_kv_heads
    kk = _repeat_kv(k, n_rep)
    vv = _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    s_ = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), kk.float())
    kv_idx = torch.arange(s_cache, device=dev)
    if is_ring:
        # entry at slot i holds absolute position: valid if within window of pos
        age = torch.remainder(pos - kv_idx, s_cache)
        valid = age < min(pos + 1, cfg.window)
    else:
        valid = kv_idx <= pos
        if kind == "local" and cfg.window:
            valid &= kv_idx > pos - cfg.window
    s_ = torch.where(valid[None, None, None, :], s_, NEG)
    prob = torch.softmax(s_, dim=-1).to(vv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", prob, vv)
    out = out.reshape(b, 1, cfg.n_heads * hd).to(x.dtype)
    return out @ p["wo"].to(x.dtype), cache


def cross_attention_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return dict(
        wq=ParamSpec((d, h * hd)),
        wk=ParamSpec((d, kv * hd)),
        wv=ParamSpec((d, kv * hd)),
        wo=ParamSpec((h * hd, d)),
    )


def cross_attention(p, x, enc_kv, cfg, q_chunk: int = 1024, kv_chunk: int = 1024):
    """Decoder cross-attention; ``enc_kv = (k, v)`` precomputed from the
    encoder output (`encode_kv`), un-repeated.  The chunked online-softmax
    path, so the scores never materialize; the chunks are the reference's
    defaults (not the model's), so a 1,500-frame encoder runs in chunks of
    750."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, hd)
    k, v = enc_kv
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = chunked_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), causal=False,
                            cross=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = out.reshape(b, s, cfg.n_heads * hd)
    return out.to(x.dtype) @ p["wo"].to(x.dtype)


def encode_kv(p, enc_out, cfg):
    """The cross-attention keys and values of the encoder output, (B,
    S_enc, KV, D) each."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    return k, v


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return dict(
        w_gate=ParamSpec((d, f)),
        w_up=ParamSpec((d, f)),
        w_down=ParamSpec((f, d)),
    )


def mlp(p, x, cfg):
    a = act_fn(cfg.act)
    h = a(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (fine-grained: shared + routed top-k, sort-based dispatch)
# ---------------------------------------------------------------------------


def moe_specs(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = dict(
        router=ParamSpec((d, e)),
        we_gate=ParamSpec((e, d, f)),
        we_up=ParamSpec((e, d, f)),
        we_down=ParamSpec((e, f, d)),
    )
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        s.update(
            ws_gate=ParamSpec((d, fs)),
            ws_up=ParamSpec((d, fs)),
            ws_down=ParamSpec((fs, d)),
        )
    return s


class Routing(NamedTuple):
    """One MoE layer's routing of ``G`` groups of ``Ng`` tokens.  The flat
    assignments (``Ng * k`` per group) are sorted expert-major, stably, so
    within an expert earlier tokens come first."""

    probs: torch.Tensor  # (G, Ng, E) fp32 router probabilities
    expert_idx: torch.Tensor  # (G, Ng, k) top-k experts, the lower index first on ties
    gate_vals: torch.Tensor  # (G, Ng, k) top-k probabilities renormalized to sum 1
    aux_loss: torch.Tensor  # () Switch-style load-balancing loss
    cap: int  # slots per expert and group
    order: torch.Tensor  # (G, Ng*k) sorted position -> flat (token-major) index
    keep: torch.Tensor  # (G, Ng*k) the sorted assignment fits its expert's capacity
    dst: torch.Tensor  # (G, Ng*k) its slot in the (E * cap) buffer (0 of its expert if dropped)


def moe_route(p, xt: torch.Tensor, cfg) -> Routing:
    """Top-k routing, the aux loss, and each assignment's capacity slot.

    xt: (G, Ng, D).  The capacity is ``min(max(ceil(Ng*k/E * cf), 8),
    Ng*k)``; an expert's assignments beyond it are dropped, earliest
    tokens kept (the reference's stable sort)."""
    g, ng, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)  # (G, Ng, E)
    # jax.lax.top_k's order: descending, the lower index first on ties
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # aux load-balancing loss (Switch-style), group-averaged
    me = probs.mean((0, 1))
    # counts as float adds of 1.0: exact in any order, and no host sync
    # (bincount sizes its output from the data's max on the card)
    flat_idx = expert_idx.reshape(-1)
    ce = torch.zeros(e, dtype=torch.float32, device=xt.device).index_add_(
        0, flat_idx, torch.ones(flat_idx.shape, dtype=torch.float32, device=xt.device))
    ce = ce / (g * ng * k)
    aux_loss = e * torch.sum(me * ce)

    cap = int(math.ceil(ng * k / e * cfg.capacity_factor))
    cap = min(max(cap, 8), ng * k)

    flat_expert = expert_idx.reshape(g, ng * k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    se = flat_expert.gather(1, order)
    run_start = torch.searchsorted(
        se, torch.arange(e, device=xt.device).expand(g, e).contiguous(), side="left")
    pos_in_e = torch.arange(ng * k, device=xt.device) - run_start.gather(1, se)
    keep = pos_in_e < cap
    dst = se * cap + torch.where(keep, pos_in_e, 0)
    return Routing(probs, expert_idx, gate_vals, aux_loss, cap, order, keep, dst)


def moe_ffn(p, x: torch.Tensor, cfg, n_groups: int = 1):
    """Fine-grained MoE with grouped sort-based dispatch (GShard groups).

    Tokens are split into ``n_groups`` groups (the reference's data
    shards; one card serves one group) and all routing bookkeeping is
    group-local.  Every expert runs over its whole ``(G, cap, D)`` slice of
    the dispatch buffer, as in the reference.  Overflow beyond capacity is
    dropped.  The combine sums each token's kept contributions in
    ascending expert order, the order of the reference's sorted
    scatter-add, with plain adds (no atomics), so it is deterministic on
    the card.  Returns ``(out, aux_loss)``.
    """
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    g = math.gcd(n_groups, n) if n_groups > 1 else 1
    ng = n // g
    xt = x.reshape(g, ng, d)
    a = act_fn(cfg.act)
    r = moe_route(p, xt, cfg)
    cap = r.cap

    st = r.order // k  # token of each sorted assignment
    sg = r.gate_vals.reshape(g, ng * k).gather(1, r.order)
    keep = r.keep[..., None]
    gathered = torch.where(keep, xt.gather(1, st[..., None].expand(-1, -1, d)), 0)
    # kept slots are unique; a dropped assignment adds exact zeros
    buf = torch.zeros((g, e * cap, d), dtype=xt.dtype, device=xt.device).scatter_add_(
        1, r.dst[..., None].expand(-1, -1, d), gathered).reshape(g, e, cap, d)

    h = a(torch.einsum("gecd,edf->gecf", buf, p["we_gate"].to(buf.dtype))) * torch.einsum(
        "gecd,edf->gecf", buf, p["we_up"].to(buf.dtype))
    y = torch.einsum("gecf,efd->gecd", h, p["we_down"].to(buf.dtype)).reshape(g, e * cap, d)

    yd = y.gather(1, r.dst[..., None].expand(-1, -1, d))  # (G, Ng*k, D)
    contrib = torch.where(keep, yd * sg[..., None].to(y.dtype), 0)
    # each token's k sorted positions, in ascending expert order
    inv = torch.empty_like(r.order).scatter_(
        1, r.order, torch.arange(ng * k, device=x.device).expand(g, -1).contiguous())
    pos = inv.reshape(g, ng, k).gather(2, torch.argsort(r.expert_idx, dim=-1))
    per_tok = contrib.gather(1, pos.reshape(g, ng * k, 1).expand(-1, -1, d)).reshape(g, ng, k, d)
    out = torch.zeros((g, ng, d), dtype=xt.dtype, device=x.device)
    for j in range(k):
        out = out + per_tok[:, :, j]

    if cfg.n_shared_experts:
        hs = a(xt @ p["ws_gate"].to(xt.dtype)) * (xt @ p["ws_up"].to(xt.dtype))
        out = out + hs @ p["ws_down"].to(xt.dtype)
    return out.reshape(b, s, d), r.aux_loss


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg) -> dict:
    v = cfg.padded_vocab
    s = dict(tok=ParamSpec((v, cfg.d_model)))
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, v))
    return s


def embed(p, tokens, cfg):
    # F.embedding: the same rows as indexing; its backward on the card is a
    # sorted segment sum, so a train step repeats bit for bit
    return F.embedding(tokens, p["tok"]) * math.sqrt(cfg.d_model)


def unembed(p, x, cfg):
    """Logits over the padded vocab; pad rows masked to -1e30 (Megatron-style
    padded-vocab softmax -- semantics identical to the unpadded model)."""
    if cfg.tie_embeddings:
        logits = x @ p["tok"].to(x.dtype).T
    else:
        logits = x @ p["unembed"].to(x.dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG)  # out of place: tanh's backward reads its output
    return logits
