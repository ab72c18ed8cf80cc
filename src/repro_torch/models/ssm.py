"""Recurrent blocks of the port (PyTorch): Mamba-2 (SSD, state-space
duality) and RG-LRU (Griffin / RecurrentGemma).

Mirrors the reference's ``models/ssm.py`` function by function.  Forward
(prefill) paths use the chunked-parallel forms: the SSD chunk algorithm,
its sequential scan over chunks a Python loop here, and a log-depth scan
for RG-LRU; decode paths are O(1) recurrent state updates.

Precision follows the reference: the SSD and RG-LRU recurrences and their
states are fp32, and the leaves they read uncast (``a_log``, ``dt_bias``,
``d_skip``; ``wa``, ``ba``, ``wx``, ``bx``, ``lam``) are fp32 params
(`model.FP32_PARAMS`); the projections and convolutions run in the
activations' dtype.  A layer's cache is ``dict(conv=..., state=...)``: the
last ``conv_width - 1`` conv inputs in the activations' dtype and the fp32
recurrent state, written in place by the decode functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import NEG, ParamSpec, act_fn, rms_norm


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Depthwise causal conv of x (B, S, C) with w (W, C): returns the conv
    and the zero-left-padded input it read."""
    s = x.shape[1]
    x_pad = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    conv = sum(x_pad[:, i:i + s, :] * w[i][None, None, :] for i in range(w.shape[0])) + bias
    return conv, x_pad


def _conv_state(x_pad: torch.Tensor, pad: int) -> torch.Tensor:
    """The last ``pad`` conv inputs, a tensor of its own (decode writes it)."""
    if not pad:
        return x_pad.new_zeros((x_pad.shape[0], 0, x_pad.shape[2]))
    return x_pad[:, -pad:, :].clone()


# ---------------------------------------------------------------------------
# Mamba-2 / SSD
# ---------------------------------------------------------------------------


def mamba2_specs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.d_inner or 2 * d
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = di // hd
    g = 1  # single B/C group (mamba2 default ngroups=1)
    d_in = 2 * di + 2 * g * n + nh
    return dict(
        in_proj=ParamSpec((d, d_in), ("embed", "ssm_inner")),
        conv_w=ParamSpec((cfg.conv_width, di + 2 * g * n), ("conv", "ssm_inner")),
        conv_b=ParamSpec((di + 2 * g * n,), ("ssm_inner",), init="zeros"),
        a_log=ParamSpec((nh,), ("ssm_heads",), init="ones"),
        dt_bias=ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        d_skip=ParamSpec((nh,), ("ssm_heads",), init="ones"),
        norm=ParamSpec((di,), ("ssm_inner",), init="zeros"),
        out_proj=ParamSpec((di, d), ("ssm_inner", "embed")),
    )


def _ssd_chunked(x, dt, a, b, c, chunk: int):
    """SSD chunked scan (Mamba-2, arXiv:2405.21060 §6), in fp32.

    x: (B,S,H,P)  dt: (B,S,H)  a: (H,) negative decay rates
    b, c: (B,S,N)  (single group, broadcast over heads)
    Returns y: (B,S,H,P) and the final state (B,H,P,N).

    One chunk's quadratic intra part ((B,Q,T,H)) lives at a time.  The
    chunk must divide S (the reference's reshape fails otherwise).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"SSD chunk {chunk} does not divide the sequence length {s}")
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for q0 in range(0, s, chunk):
        xq, dtq = x[:, q0:q0 + chunk], dt[:, q0:q0 + chunk]
        bq, cq = b[:, q0:q0 + chunk], c[:, q0:q0 + chunk]
        da = dtq * a[None, None, :]  # (B,Q,H), negative
        cum = torch.cumsum(da, dim=1)
        # intra-chunk: L[q,t] = exp(cum_q - cum_t) for q >= t, masked before the exp
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Q,T,H)
        l_mat = torch.exp(torch.where(tri[None, :, :, None], seg, NEG))
        scores = torch.einsum("bqn,btn->bqt", cq, bq)
        xdt = xq * dtq[..., None]  # (B,T,H,P)
        y = torch.einsum("bqth,bthp->bqhp", scores[..., None] * l_mat, xdt)
        # carried-in state contribution
        y = y + torch.einsum("bqn,bhpn->bqhp", cq, state) * torch.exp(cum)[..., None]
        # state update
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)  # (B,Q,H)
        s_new = torch.einsum("bthp,btn->bhpn", xq * (decay_to_end * dtq)[..., None], bq)
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + s_new
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _ssd_placements(pl) -> tuple:
    """Per mesh dim, the placements `_ssd_by_shard` runs the scan at, from
    ``x``'s placement there: (x, dt, a, b, c) in, their grads, and (y,
    state) out.  An operand replicated where x is sharded is read by every
    shard, so each device's grad of it is a partial sum over its rows,
    heads or head dims: ``Partial``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    r, s = Replicate(), Partial()
    if pl == Shard(0):  # batch rows scan independently
        return (pl, pl, r, pl, pl), (pl, pl, s, pl, pl), (pl, pl)
    if pl == Shard(2):  # so do heads; b and c are shared by every head
        return (pl, pl, Shard(0), r, r), (pl, pl, Shard(0), s, s), (pl, Shard(1))
    if pl == Shard(3):  # and head dims; dt, a, b and c are shared
        return (pl, r, r, r, r), (pl, s, s, s, s), (pl, Shard(2))
    return (r,) * 5, (r,) * 5, (r, r)  # the sequence (or a partial sum) is gathered


def _ssd_by_shard(x, dt, a, b, c, chunk: int):
    """`_ssd_chunked`; on DTensors, run on each device's shard.

    The scan is independent across batch rows, heads and head dims, so a
    device that holds a shard of those scans it alone (shard_map-style,
    through `local_map`, as `layers._attend` does), as the reference's
    partitioned HLO does.  DTensor itself cannot shard the scan on every
    torch the port meets: torch 2.11's view rules refuse to flatten the
    batch and head dims together when both are sharded, which the
    intra-chunk einsum's backward does.  The shards are even (`spec_for`
    shards only a dim its mesh axes divide), as `local_map`'s outputs
    assume.  Plain tensors go straight to `_ssd_chunked`."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return _ssd_chunked(x, dt, a, b, c, chunk)
    from torch.distributed.tensor.experimental import local_map

    ins, grads, outs = zip(*(_ssd_placements(pl) for pl in x.placements))
    return local_map(_ssd_chunked, out_placements=tuple(zip(*outs)), in_placements=tuple(zip(*ins)),
                     in_grad_placements=tuple(zip(*grads)), redistribute_inputs=True,
                     )(x, dt, a, b, c, chunk=chunk)


def mamba2_forward(p, x, cfg, chunk: int | None = None):
    """Forward / prefill.  Returns (out, dict(conv=..., state=...))."""
    bsz, s, d = x.shape
    di = cfg.d_inner or 2 * d
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = di // hd

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)

    # causal depthwise conv over (x, B, C)
    conv, xbc_pad = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    conv = F.silu(conv)
    xs, b_, c_ = torch.split(conv, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"].float())  # (H,) negative
    xh = xs.reshape(bsz, s, nh, hd).float()

    y, state = _ssd_by_shard(xh, dt, a, b_.float(), c_.float(),
                             chunk=min(chunk or cfg.ssm_chunk, s))
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, dict(conv=_conv_state(xbc_pad, cfg.conv_width - 1), state=state.float())


def mamba2_decode(p, x, cfg, cache: dict):
    """Single-token decode.  cache: dict(conv=(B,W-1,di+2n), state=(B,H,P,N)),
    updated in place and returned."""
    bsz, _, d = x.shape
    di = cfg.d_inner or 2 * d
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = di // hd

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)

    w = p["conv_w"].to(x.dtype)
    hist = torch.cat([cache["conv"], xbc], dim=1)  # (B, W, di+2n)
    conv = torch.einsum("bwc,wc->bc", hist, w)[:, None, :] + p["conv_b"].to(x.dtype)
    conv = F.silu(conv)
    xs, b_, c_ = torch.split(conv, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])  # (B,1,H)
    a = -torch.exp(p["a_log"].float())
    xh = xs.reshape(bsz, nh, hd).float()

    decay = torch.exp(dt[:, 0, :] * a[None, :])  # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[:, 0, :, None], b_[:, 0].float())
    ssm_new = cache["state"] * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c_[:, 0].float(), ssm_new)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    cache["conv"].copy_(hist[:, 1:, :])
    cache["state"].copy_(ssm_new)
    return out, cache


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def rglru_specs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    return dict(
        in_x=ParamSpec((d, w), ("embed", "lru")),
        in_gate=ParamSpec((d, w), ("embed", "lru")),
        conv_w=ParamSpec((cfg.conv_width, w), ("conv", "lru")),
        conv_b=ParamSpec((w,), ("lru",), init="zeros"),
        wa=ParamSpec((w, w), ("lru", None)),
        ba=ParamSpec((w,), (None,), init="zeros"),
        wx=ParamSpec((w, w), ("lru", None)),
        bx=ParamSpec((w,), (None,), init="zeros"),
        lam=ParamSpec((w,), (None,), init="ones"),
        out_proj=ParamSpec((w, d), ("lru", "embed")),
    )


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t along dim 1 in
    ceil(log2 S) steps (Hillis-Steele); returns (cumulative a, h)."""
    s = a.shape[1]
    step = 1
    while step < s:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return a, b


def _rglru_scan(a, b, chunk: int = 512):
    """Scan over h_t = a_t * h_{t-1} + b_t (diagonal recurrence).

    The reference's hybrid form: a log-depth scan within chunks, a
    sequential loop across them; one flat scan when ``s <= chunk`` or the
    chunk does not divide ``s``.  Returns (cumulative_a, h).
    """
    bsz, s, w = a.shape
    if s <= chunk or s % chunk != 0:
        return _assoc_scan(a, b)
    h_prev = torch.zeros((bsz, w), dtype=a.dtype, device=a.device)
    a_all, h_all = [], []
    for c0 in range(0, s, chunk):
        a_cum, b_cum = _assoc_scan(a[:, c0:c0 + chunk], b[:, c0:c0 + chunk])
        h = a_cum * h_prev[:, None, :] + b_cum
        h_prev = h[:, -1, :]
        a_all.append(a_cum)
        h_all.append(h)
    return torch.cat(a_all, dim=1), torch.cat(h_all, dim=1)


def _rglru_gates(p, u: torch.Tensor):
    """fp32 recurrence gate ``log_a`` and input gate ``i`` of conv output u."""
    r = torch.sigmoid(u @ p["wa"] + p["ba"])
    i = torch.sigmoid(u @ p["wx"] + p["bx"])
    return -_RGLRU_C * r * F.softplus(p["lam"])[None, None, :], i


def rglru_forward(p, x, cfg):
    """Forward / prefill.  Returns (out, dict(conv=..., state=...))."""
    gelu = act_fn("gelu")
    gate = gelu(x @ p["in_gate"].to(x.dtype))
    xs = x @ p["in_x"].to(x.dtype)
    conv, xs_pad = _causal_conv(xs, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))

    u = conv.float()
    log_a, i = _rglru_gates(p, u)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (u * i)
    _, h = _rglru_scan(a, b)

    y = (h.to(x.dtype) * gate) @ p["out_proj"].to(x.dtype)
    return y, dict(conv=_conv_state(xs_pad, cfg.conv_width - 1), state=h[:, -1, :].clone())


def rglru_decode(p, x, cfg, cache: dict):
    """Single-token decode.  cache: dict(conv=(B,W-1,w), state=(B,w)),
    updated in place and returned."""
    gelu = act_fn("gelu")
    gate = gelu(x @ p["in_gate"].to(x.dtype))
    xs = x @ p["in_x"].to(x.dtype)
    hist = torch.cat([cache["conv"], xs], dim=1)
    conv = torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(x.dtype))[:, None, :] \
        + p["conv_b"].to(x.dtype)

    u = conv.float()
    log_a, i = _rglru_gates(p, u)
    a = torch.exp(log_a)[:, 0]
    b = torch.sqrt(torch.clamp(1.0 - a**2, min=1e-6)) * (u[:, 0] * i[:, 0])
    h = a * cache["state"] + b
    y = (h[:, None, :].to(x.dtype) * gate) @ p["out_proj"].to(x.dtype)
    cache["conv"].copy_(hist[:, 1:, :])
    cache["state"].copy_(h)
    return y, cache
