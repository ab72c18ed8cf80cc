"""Plain float32 reference of the stand-in architecture
(``standin/archs/qkv_bias.py``): `reference.decoder`'s block with q, k and
v biased before the rotary positions, and the final norm's gain held as
``ln_f``.  ``CALLS`` names the functions of this module that were
called."""

import math

import torch
import torch.utils.checkpoint

from portbench.reference import decoder as D

CALLS: set = set()


def attention(a, W, i, h, lowp):
    b, t, _ = h.shape
    hd = a.head_dim
    q = (D.mm(h, W["wq"][i], lowp) + W["bq"][i].float()).view(b, t, a.n_heads, hd)
    k = (D.mm(h, W["wk"][i], lowp) + W["bk"][i].float()).view(b, t, a.n_kv_heads, hd)
    v = (D.mm(h, W["wv"][i], lowp) + W["bv"][i].float()).view(b, t, a.n_kv_heads, hd)
    q, k = D.rope(q, a.rope_theta), D.rope(k, a.rope_theta)
    rep = a.n_heads // a.n_kv_heads
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))
    s = D.mm(q, k.transpose(-1, -2), lowp) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = D.mm(p, v, lowp).transpose(1, 2).reshape(b, t, a.n_heads * hd)
    return D.mm(o, W["wo"][i], lowp)


def block(a, W, i, x, prompt_len, lowp):
    x = x + attention(a, W, i, D.rms_norm(x, W["norm1"][i], a.norm_eps), lowp)
    h = D.rms_norm(x, W["norm2"][i], a.norm_eps)
    if i < a.dense_layers:
        return x + D.dense_ffn(a, W, i, h, lowp)
    return x + D.moe_ffn(a, W, i - a.dense_layers, h, prompt_len, lowp)


def hidden(a, W, tokens, prompt_len=None, lowp=False, checkpoint=False):
    CALLS.add("hidden")
    p = tokens.shape[1] if prompt_len is None else prompt_len
    x = D.embed(a, W, tokens)
    for i in range(a.n_layers):
        if checkpoint and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(block, a, W, i, x, p, lowp, use_reentrant=False)
        else:
            x = block(a, W, i, x, p, lowp)
    return x


def unembed(a, W, x, lowp):
    CALLS.add("unembed")
    return D.unembed(a, dict(W, final_norm=W["ln_f"]), x, lowp)


def served_logits(a, W, tokens, prompt_len, lowp=False):
    CALLS.add("served_logits")
    x = hidden(a, W, tokens, prompt_len, lowp)
    return unembed(a, W, x[:, prompt_len - 1:], lowp)
