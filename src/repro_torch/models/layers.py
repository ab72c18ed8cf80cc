"""Transformer building blocks of the port (PyTorch).

Mirrors the reference's ``models/layers.py`` function by function: param
specs, norms, rope, chunked online-softmax attention (train / prefill)
and single-token decode attention against a KV cache (on CUDA tensors off
a mesh one hand kernel, `kernels.decode_attn`), multi-head latent
attention (not absorbed over the sequence, absorbed over a latent cache
at decode), the decoder's cross-attention over encoder keys and values,
the gated MLP, the
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
import functools
import math
from typing import Callable, Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import decode_attn as _decode_attn
from ..runtime import trace

#: mask value of scores and padded vocab rows (the reference's)
NEG = -1e30


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A leaf's shape, logical (sharding) axes, init and std multiplier.
    ``logical`` names each dim's axis for `parallel.sharding.spec_for`
    (``None`` for a dim that never shards)."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
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
        return dataclasses.replace(specs, shape=(n, *specs.shape),
                                   logical=("layers", *specs.logical))
    return {k: stack_specs(v, n) for k, v in specs.items()}


def logical_tree(specs):
    """The spec tree's logical axes, keyed like it."""
    if is_spec(specs):
        return specs.logical
    return {k: logical_tree(v) for k, v in specs.items()}


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
    zeros, or by ``place(spec, dtype)``, e.g. sharded on a mesh) in
    ``dtype``, except those whose dotted path from the root is in ``fp32``,
    which stay fp32."""

    def __init__(self, specs: Mapping, device: torch.device,
                 dtype: torch.dtype = torch.float32, fp32=frozenset(), prefix: str = "",
                 place: "Callable[[ParamSpec, torch.dtype], torch.Tensor] | None" = None):
        super().__init__()
        for k, s in specs.items():
            if is_spec(s):
                dt = torch.float32 if prefix + k in fp32 else dtype
                t = (place(s, dt) if place is not None
                     else torch.zeros(s.shape, dtype=dt, device=device))
                self.register_parameter(k, nn.Parameter(t, requires_grad=False))
            else:
                self.add_module(k, ParamTree(s, device, dtype, fp32, f"{prefix}{k}.", place))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# ---------------------------------------------------------------------------
# Reshapes on a mesh
# ---------------------------------------------------------------------------


def _view_groups(src, dst) -> list[tuple[list[int], list[int]]]:
    """Pair up the dims of a view ``src -> dst``: runs of source dims and
    of destination dims with equal products."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        si, dj = [], []
        ps = pd = 1
        while True:
            if ps <= pd and i < len(src) and (not si or ps < pd or src[i] == 1):
                ps *= src[i]
                si.append(i)
                i += 1
            elif j < len(dst) and (not dj or pd < ps or dst[j] == 1):
                pd *= dst[j]
                dj.append(j)
                j += 1
            else:
                break
            if ps == pd and si and dj:
                break
        groups.append((si, dj))
    return groups


def reshape(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(shape)``.  A DTensor is first gathered on every sharded
    dim the view cannot keep sharded -- one that is not the outer dim of
    the dims it merges with, is sharded unevenly, or whose outer output dim
    its shard count does not divide -- since DTensor refuses such a view
    where GSPMD reshards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t.reshape(*shape)
    src = tuple(t.shape)
    shape = torch.empty(src, device="meta").reshape(*shape).shape
    mesh = t.device_mesh
    count = {}
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard):
            count[pl.dim] = count.get(pl.dim, 1) * mesh.size(i)
    keep = set()
    for si, dj in _view_groups(src, tuple(shape)):
        lead = [d for d in si if src[d] > 1][:1]
        for d in si:
            if (d in count and d in lead and dj and src[d] % count[d] == 0
                    and shape[dj[0]] % count[d] == 0):
                keep.add(d)
    want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim not in keep else pl
                 for pl in t.placements)
    if want != tuple(t.placements):
        t = t.redistribute(mesh, want)
    return t.contiguous().view(shape)  # torch 2.11's DTensor views strictly


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
        wq=ParamSpec((d, h * hd), ("embed", "qkv")),
        wk=ParamSpec((d, kv * hd), ("embed", "qkv")),
        wv=ParamSpec((d, kv * hd), ("embed", "qkv")),
        wo=ParamSpec((h * hd, d), ("qkv", "embed")),
    )
    if cfg.qkv_bias:
        s.update(
            bq=ParamSpec((h * hd,), ("qkv",), init="zeros"),
            bk=ParamSpec((kv * hd,), ("qkv",), init="zeros"),
            bv=ParamSpec((kv * hd,), ("qkv",), init="zeros"),
        )
    if cfg.qk_norm:
        s.update(
            q_norm=ParamSpec((hd,), (None,), init="zeros"),
            k_norm=ParamSpec((hd,), (None,), init="zeros"),
        )
    return s


def _project(p, x, cfg):
    """q (B, S, H, D), k and v (B, S, KV, D) of ``x``: the projections, the
    biases and (``qk_norm``) the norms, before RoPE."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = reshape(q, b, s, cfg.n_heads, hd)
    k = reshape(k, b, s, cfg.n_kv_heads, hd)
    v = reshape(v, b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _project_qkv(p, x, cfg, positions, theta):
    q, k, v = _project(p, x, cfg)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


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


#: q, k and v of an attention on a mesh: batch over data, heads over model
#: where they divide, the sequence whole (gathered ONCE, before the loops)
HOIST = ("batch", None, "act_heads", None)


def _attend(fn, q, k, v, constrain_fn=None, hoist_kv: bool = True):
    """``fn(q, k, v)``, each (B, S, H, D) and the output (B, Sq, H, D).  On
    a mesh (``constrain_fn``) q -- and k, v with ``hoist_kv`` -- are
    placed by `HOIST`; where the three then sit alike, ``fn`` runs on each
    device's shard (shard_map-style: attention is batch- and
    head-parallel), since DTensor would flatten two sharded dims into its
    matmuls as a strided shard, which torch 2.13's plans slowly and 2.11's
    cannot do at all.  Otherwise ``fn`` runs on the DTensors as they
    are."""
    if constrain_fn is None:
        return fn(q, k, v)
    q = constrain_fn(q, HOIST)
    if hoist_kv:
        k, v = constrain_fn(k, HOIST), constrain_fn(v, HOIST)
    if not (q.placements == k.placements == v.placements):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    pl = list(q.placements)  # a list: one output (a tuple would mean one per output)
    return local_map(fn, out_placements=pl, in_placements=(pl,) * 3)(q, k, v)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q @ k^T`` accumulated in fp32 (the reference's
    ``preferred_element_type=float32``): bf16 operands upcast exactly."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, H, D)  (already GQA-repeated)
    v: torch.Tensor,  # (B, Skv, H, Dv)
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
    ``cross`` (queries over another sequence's keys) turns it off.  The
    values may be narrower than the keys (latent attention's 128 against
    192); the scale is the keys' ``1 / sqrt(D)``.  Returns (B, Sq, H, Dv).
    """
    b, sq, h, d = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    q_chunk = _pick_chunk(sq, q_chunk)
    kv_chunk = _pick_chunk(skv, kv_chunk)
    nq, nkv = sq // q_chunk, skv // kv_chunk
    scale = 1.0 / math.sqrt(d)

    qc = q.reshape(b, nq, q_chunk, h, d).permute(1, 0, 3, 2, 4) * scale  # (nq,B,H,qc,D)
    kc = k.reshape(b, nkv, kv_chunk, h, d).permute(1, 0, 3, 2, 4)  # (nkv,B,H,kc,D)
    vc = v.reshape(b, nkv, kv_chunk, h, dv).permute(1, 0, 3, 2, 4)
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev).reshape(nq, q_chunk)
    kv_pos_base = torch.arange(kv_chunk, device=dev)

    m = torch.full((nq, b, h, q_chunk), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((nq, b, h, q_chunk), dtype=torch.float32, device=dev)
    acc = torch.zeros((nq, b, h, q_chunk, dv), dtype=torch.float32, device=dev)
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
    # (nq, B, H, qc, Dv) -> (B, Sq, H, Dv)
    return out.permute(1, 0, 3, 2, 4).reshape(b, sq, h, dv)


def attention_train(p, x, cfg, kind: str, theta: float, q_chunk: int = 1024,
                    kv_chunk: int = 1024, constrain_fn=None):
    """Full-sequence (forward/prefill) attention for one layer.

    Returns ``(out, (k, v))`` with k, v un-repeated (B, S, KV, D): the
    prefill cache (the reference repeats and then strides back to the same
    values).  ``constrain_fn`` (on a mesh) hoists the sequence-parallel
    gather of q and the repeated k, v to one redistribute each before the
    chunk loop, as the reference does (`_attend`)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    window = cfg.window if kind == "local" else 0
    out = _attend(functools.partial(chunked_attention, causal=True, window=window,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk),
                  q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), constrain_fn)
    out = reshape(out, b, s, cfg.n_heads * cfg.resolved_head_dim).to(x.dtype)
    return out @ p["wo"].to(x.dtype), (k, v)


@functools.lru_cache(maxsize=None)
def rope_inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """`rope_freqs` once per (head_dim, theta, device): the decode kernel's
    operand (the same numbers as the plain version's per-call ones)."""
    return rope_freqs(head_dim, theta, device)


def _is_ring(kind: str, cfg, s_cache: int) -> bool:
    """Whether a decode cache is a local layer's ring (``s_cache <=
    window``): position p at slot p mod ``s_cache``; else at slot p."""
    return bool(kind == "local" and cfg.window and cfg.window < 10**9 and s_cache <= cfg.window)


def decode_window(kind: str, cfg, s_cache: int, pos: int) -> tuple[int, int]:
    """``(first, n)``: the slots a decode step at ``pos`` attends over an
    ``s_cache``-slot cache, ``n`` of them from ``first`` on, modulo
    ``s_cache`` (`_is_ring`); the last is the new entry's."""
    if _is_ring(kind, cfg, s_cache):
        n = min(pos + 1, cfg.window, s_cache)
        return (pos - n + 1) % s_cache, n
    if pos >= s_cache:
        raise IndexError(f"decode position {pos} beyond the cache's {s_cache} slots")
    lo = max(0, pos - cfg.window + 1) if kind == "local" and cfg.window else 0
    return lo, pos + 1 - lo


def _uses_kernel(x: torch.Tensor, constrain_fn) -> bool:
    """Whether `attention_decode` runs the hand kernel: on CUDA, off a mesh."""
    return constrain_fn is None and x.device.type == "cuda"


def prefetch_decode_kernel(x: torch.Tensor, constrain_fn=None) -> None:
    """Start building the decode kernel in the background where
    `attention_decode` would launch it for ``x`` (a prefill calls this, so
    that the build overlaps the prompt pass)."""
    if _uses_kernel(x, constrain_fn):
        _decode_attn.prefetch()


def decode_attend_kernel(q, k_new, v_new, cache: dict, cfg, kind: str, theta: float,
                         pos: int) -> torch.Tensor:
    """`decode_attend` as one launch of `kernels.decode_attn` (CUDA
    tensors): the same operands and result."""
    hd = q.shape[-1]
    first, n = decode_window(kind, cfg, cache["k"].shape[1], pos)
    out = _decode_attn.decode_attention(
        q, k_new, v_new, cache["k"], cache["v"], rope_inv_freq(hd, theta, q.device), pos,
        first, n, 1.0 / math.sqrt(hd))
    trace.count("attn.decode_kernel", 1)
    return out


def decode_attend(q, k_new, v_new, cache: dict, cfg, kind: str, theta: float, pos: int,
                  constrain_fn=None) -> torch.Tensor:
    """The plain version of the decode kernel: RoPE of ``q`` (B, 1, H, D)
    and ``k_new`` (B, 1, KV, D) at ``pos``, the append of ``k_new`` and
    ``v_new`` into the cache at their slot, and attention over the valid
    slots; returns (B, 1, H, D).  On a mesh (``constrain_fn``) q is placed
    as the cache's heads are (`_attend`)."""
    b, _, _, hd = q.shape
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=q.device)
    q = apply_rope(q, positions, theta)
    k_new = apply_rope(k_new, positions, theta)

    s_cache = cache["k"].shape[1]
    is_ring = _is_ring(kind, cfg, s_cache)
    slot = pos % s_cache if is_ring else pos
    k, v = cache["k"], cache["v"]
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)

    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = 1.0 / math.sqrt(hd)

    def attend(q, k, v):
        kk = _repeat_kv(k, n_rep)
        vv = _repeat_kv(v, n_rep)
        s_ = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), kk.float())
        kv_idx = torch.arange(s_cache, device=q.device)
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
        return torch.einsum("bhqk,bkhd->bqhd", prob, vv)

    return _attend(attend, q, k, v, constrain_fn, hoist_kv=False)


def attention_decode(p, x, cfg, kind: str, theta: float, cache: dict, pos: int,
                     constrain_fn=None):
    """Single-token decode against a KV cache, updated in place.

    cache: dict(k=(B, S_cache, KV, D), v=...);  pos: the current index, a
    host int (one for the whole batch), so nothing here syncs.  Local
    layers use a ring cache of size ``window`` -- positions are mapped
    modulo the ring.  The projections run here; RoPE, the append and the
    attention are one hand kernel on CUDA tensors off a mesh
    (`decode_attend_kernel`), else the plain version (`decode_attend`;
    on a mesh, ``constrain_fn``, over DTensors)."""
    b = x.shape[0]
    q, k_new, v_new = _project(p, x, cfg)
    if _uses_kernel(x, constrain_fn):
        out = decode_attend_kernel(q, k_new, v_new, cache, cfg, kind, theta, pos)
    else:
        out = decode_attend(q, k_new, v_new, cache, cfg, kind, theta, pos, constrain_fn)
    out = reshape(out, b, 1, cfg.n_heads * cfg.resolved_head_dim).to(x.dtype)
    return out @ p["wo"].to(x.dtype), cache


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2/V3)
# ---------------------------------------------------------------------------


def mla_specs(cfg) -> dict:
    """An ``mla`` layer's attention: ``wq`` (d -> heads x (nope + rope)),
    ``wkv_a`` (d -> the latent and the rotary key every head shares), the
    latent's norm ``kv_norm``, ``wkv_b`` (latent -> heads x (nope key +
    value): W_UK and W_UV side by side in each head) and ``wo``."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return dict(
        wq=ParamSpec((d, h * (dn + dr)), ("embed", "qkv")),
        wkv_a=ParamSpec((d, r + dr), ("embed", None)),
        kv_norm=ParamSpec((r,), (None,), init="zeros"),
        wkv_b=ParamSpec((r, h * (dn + dv)), (None, "qkv")),
        wo=ParamSpec((h * dv, d), ("qkv", "embed")),
    )


def mla_project(p, x, cfg, positions):
    """Of ``x`` (B, S, D) at ``positions``: q's parts without and with
    positions, (B, S, H, nope) and (B, S, H, rope), the normed latent (B,
    S, r) and the rotary key (B, S, rope), RoPE applied as `apply_rope`
    does (rotary halves, fp32 angles)."""
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ p["wq"].to(x.dtype)).view(b, s, h, dn + dr)
    q_nope, q_rope = q.split([dn, dr], dim=-1)
    c, k_rope = (x @ p["wkv_a"].to(x.dtype)).split([r, dr], dim=-1)
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c, k_rope


def mla_train(p, x, cfg, q_chunk: int = 1024, kv_chunk: int = 1024):
    """Full-sequence (forward/prefill) latent attention, not absorbed: each
    head's nope key and value expanded from the latent, then causal
    `chunked_attention` over (nope + rope)-wide keys and ``v_head_dim``-wide
    values.  Returns ``(out, (c, k_rope))``: the normed latent and the
    rotary key are the decode cache.  Spans ``mla.project`` (q, the latent,
    its norm, RoPE), ``mla.attend`` (the expansion and the attention) and
    ``mla.out`` (``wo``)."""
    b, s, _ = x.shape
    h, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    with trace.span("mla.project"):
        positions = torch.arange(s, device=x.device)[None, :]
        q_nope, q_rope, c, k_rope = mla_project(p, x, cfg, positions)
    with trace.span("mla.attend"):
        k_nope, v = (c @ p["wkv_b"].to(x.dtype)).view(b, s, h, dn + dv).split([dn, dv], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(-1, -1, h, -1)], dim=-1)
        out = chunked_attention(q, k, v, causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    with trace.span("mla.out"):
        out = out.reshape(b, s, h * dv).to(x.dtype) @ p["wo"].to(x.dtype)
    return out, (c, k_rope)


def mla_decode(p, x, cfg, cache: dict, pos: int):
    """One token of latent attention, absorbed.  The step's latent and rotary
    key are appended to the cache (``dict(c=(B, S, r), kr=(B, S, rope))``,
    updated in place) at ``pos``, a host int; each head's nope query is
    taken into the latent space through its W_UK (its slice of ``wkv_b``);
    the scores are over the latent and the rotary key of every slot up to
    ``pos``, the left pads included; the probabilities weigh the latents,
    and each head's sum goes through its W_UV, then ``wo``.  Per-head keys
    and values are never formed.  The absorbed query, the scores, the
    softmax and both sums are fp32 (bf16 operands upcast exactly); the
    probabilities are cast to the cache's dtype first, as `decode_attend`
    casts them to the values'.  Spans as `mla_train`'s; ``mla.attend``
    carries ``rows`` and ``slots`` (the slots each row reads) while the
    tracer is on."""
    b = x.shape[0]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if pos >= cache["c"].shape[1]:
        raise IndexError(f"decode position {pos} beyond the cache's {cache['c'].shape[1]} slots")
    with trace.span("mla.project"):
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q_nope, q_rope, c_new, kr_new = mla_project(p, x, cfg, positions)
        cache["c"][:, pos] = c_new[:, 0].to(cache["c"].dtype)
        cache["kr"][:, pos] = kr_new[:, 0].to(cache["kr"].dtype)
    w = p["wkv_b"].view(r, h, dn + dv)
    with trace.span("mla.attend", dict(rows=b, slots=pos + 1) if trace.active() else None):
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w[..., :dn].float())
        c = cache["c"][:, :pos + 1].float()  # (B, n, r)
        kr = cache["kr"][:, :pos + 1].float()  # (B, n, rope)
        s_ = (torch.matmul(q_lat, c.transpose(1, 2))
              + torch.matmul(q_rope[:, 0].float(), kr.transpose(1, 2)))
        prob = torch.softmax(s_ * (1.0 / math.sqrt(dn + dr)), dim=-1).to(cache["c"].dtype)
        o_lat = torch.matmul(prob.float(), c)  # (B, H, r)
    with trace.span("mla.out"):
        o = torch.einsum("bhr,rhv->bhv", o_lat, w[..., dn:].float())
        out = o.reshape(b, 1, h * dv).to(x.dtype) @ p["wo"].to(x.dtype)
    return out, cache


def cross_attention_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return dict(
        wq=ParamSpec((d, h * hd), ("embed", "qkv")),
        wk=ParamSpec((d, kv * hd), ("embed", "qkv")),
        wv=ParamSpec((d, kv * hd), ("embed", "qkv")),
        wo=ParamSpec((h * hd, d), ("qkv", "embed")),
    )


def cross_attention(p, x, enc_kv, cfg, q_chunk: int = 1024, kv_chunk: int = 1024,
                    constrain_fn=None):
    """Decoder cross-attention; ``enc_kv = (k, v)`` precomputed from the
    encoder output (`encode_kv`), un-repeated.  The chunked online-softmax
    path, so the scores never materialize; the chunks are the reference's
    defaults (not the model's), so a 1,500-frame encoder runs in chunks of
    750."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = reshape(x @ p["wq"].to(x.dtype), b, s, cfg.n_heads, hd)
    k, v = enc_kv
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = _attend(functools.partial(chunked_attention, causal=False, cross=True,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk),
                  q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), constrain_fn)
    out = reshape(out, b, s, cfg.n_heads * hd)
    return out.to(x.dtype) @ p["wo"].to(x.dtype)


def encode_kv(p, enc_out, cfg):
    """The cross-attention keys and values of the encoder output, (B,
    S_enc, KV, D) each."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = reshape(enc_out @ p["wk"].to(enc_out.dtype), b, s, cfg.n_kv_heads, hd)
    v = reshape(enc_out @ p["wv"].to(enc_out.dtype), b, s, cfg.n_kv_heads, hd)
    return k, v


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return dict(
        w_gate=ParamSpec((d, f), ("embed", "mlp")),
        w_up=ParamSpec((d, f), ("embed", "mlp")),
        w_down=ParamSpec((f, d), ("mlp", "embed")),
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
        router=ParamSpec((d, e), ("embed", "experts")),
        we_gate=ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        we_up=ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        we_down=ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
    )
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        s.update(
            ws_gate=ParamSpec((d, fs), ("embed", "mlp")),
            ws_up=ParamSpec((d, fs), ("embed", "mlp")),
            ws_down=ParamSpec((fs, d), ("mlp", "embed")),
        )
    if cfg.router_scoring == "sigmoid":  # the selection bias, fp32 (`model.FP32_PARAMS`)
        s["router_bias"] = ParamSpec((e,), (None,), init="zeros")
    return s


class Routing(NamedTuple):
    """One MoE layer's routing of ``G`` groups of ``Ng`` tokens.  The flat
    assignments (``Ng * k`` per group) are sorted expert-major, stably, so
    within an expert earlier tokens come first."""

    probs: torch.Tensor  # (G, Ng, E) fp32 router probabilities (sigmoid: scores over their sum)
    expert_idx: torch.Tensor  # (G, Ng, k) top-k experts, the lower index first on ties
    gate_vals: torch.Tensor  # (G, Ng, k) top-k probabilities or scores renormalized to sum 1
    #                          (times ``routed_scale``)
    aux_loss: torch.Tensor  # () Switch-style load-balancing loss
    cap: int  # slots per expert and group
    order: torch.Tensor  # (G, Ng*k) sorted position -> flat (token-major) index
    keep: torch.Tensor  # (G, Ng*k) the sorted assignment fits its expert's capacity
    dst: torch.Tensor  # (G, Ng*k) its slot in the (E * cap) buffer (0 of its expert if dropped)


def moe_route(p, xt: torch.Tensor, cfg) -> Routing:
    """Top-k routing, the aux loss, and each assignment's capacity slot.

    xt: (G, Ng, D).  ``cfg.router_scoring`` "softmax": the top-k of the
    probabilities, renormalized.  "sigmoid" (DeepSeek-V3's ``noaux_tc``
    with one group): the top-k of the sigmoid scores (of fp32 logits) plus
    the fp32 ``router_bias``, which moves the choice and not the gates;
    the gates are the chosen experts' scores,
    renormalized, and the aux loss reads the scores over their sum.  Both
    times ``routed_scale`` where it is not 1.  The capacity is
    ``min(max(ceil(Ng*k/E * cf), 8), Ng*k)``; an expert's assignments
    beyond it are dropped, earliest tokens kept (the reference's stable
    sort)."""
    g, ng, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    if cfg.router_scoring == "sigmoid":
        # fp32 logits, as DeepSeek-V3's gate computes them
        scores = torch.sigmoid(xt.float() @ p["router"].float())
        choice = scores + p["router_bias"].float()
        expert_idx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][..., :k]
        gate_vals = scores.gather(-1, expert_idx)
        probs = scores / scores.sum(-1, keepdim=True)
    else:
        logits = (xt @ p["router"].to(xt.dtype)).float()
        probs = torch.softmax(logits, dim=-1)  # (G, Ng, E)
        # jax.lax.top_k's order: descending, the lower index first on ties
        gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    if cfg.routed_scale != 1.0:
        gate_vals = gate_vals * cfg.routed_scale

    # aux load-balancing loss (Switch-style), group-averaged
    me = probs.mean((0, 1))
    # counts as float sums of ones: exact in any order, and no host sync
    # (bincount sizes its output from the data's max on the card); a
    # compare-and-sum, which DTensor shards like any elementwise op and
    # reduction (not an index_add into a plain buffer)
    flat_idx = expert_idx.reshape(-1)
    hits = flat_idx[:, None] == torch.arange(e, device=xt.device)
    ce = hits.sum(0, dtype=torch.float32)
    ce = ce / (g * ng * k)
    aux_loss = e * torch.sum(me * ce)

    cap = int(math.ceil(ng * k / e * cfg.capacity_factor))
    cap = min(max(cap, 8), ng * k)

    flat_expert = expert_idx.reshape(g, ng * k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    se = flat_expert.gather(1, order)
    # each expert's first sorted position: the exclusive prefix sum of the
    # group's expert counts (``searchsorted(se, arange(e))``, which DTensor
    # cannot shard)
    counts = torch.zeros((g, e), dtype=se.dtype, device=xt.device).scatter_add(
        1, se, torch.ones_like(se))
    run_start = counts.cumsum(1) - counts
    pos_in_e = torch.arange(ng * k, device=xt.device) - run_start.gather(1, se)
    keep = pos_in_e < cap
    dst = se * cap + torch.where(keep, pos_in_e, 0)
    return Routing(probs, expert_idx, gate_vals, aux_loss, cap, order, keep, dst)


def moe_ffn(p, x: torch.Tensor, cfg, n_groups: int = 1, constrain_fn=None):
    """Fine-grained MoE with grouped sort-based dispatch (GShard groups).

    Tokens are split into ``n_groups`` groups (the reference's data
    shards; one card serves one group) and all routing bookkeeping is
    group-local.  Every expert runs over its whole ``(G, cap, D)`` slice of
    the dispatch buffer, as in the reference.  Overflow beyond capacity is
    dropped.  The combine sums each token's kept contributions in
    ascending expert order, the order of the reference's sorted
    scatter-add, with plain adds (no atomics), so it is deterministic on
    the card.  ``constrain_fn`` (on a mesh) places the dispatch buffer and
    the experts' outputs groups over data, experts over model (the
    reference's expert parallelism; the reference constrains them in its
    train blocks, the port in every mode).  Returns ``(out, aux_loss)``.

    Spans ``moe.route``, ``moe.experts`` (dispatch and experts) and
    ``moe.combine`` (the combine and the shared experts); counters
    ``moe.assignments``, ``moe.slots``, ``moe.slots_filled`` and
    ``moe.dropped`` (the last two from ``keep``, reduced at
    `runtime.trace.collect`).  The router is called through the module's
    `moe_route`, so a caller may wrap it.
    """
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    g = math.gcd(n_groups, n) if n_groups > 1 else 1
    ng = n // g
    xt = x.reshape(g, ng, d)
    a = act_fn(cfg.act)
    with trace.span("moe.route"):
        r = moe_route(p, xt, cfg)
        cap = r.cap
        if trace.active():
            trace.count("moe.assignments", g * ng * k)
            trace.count("moe.slots", g * e * cap)
            trace.count("moe.slots_filled", r.keep)
            trace.count("moe.dropped", r.keep, trace.falses)

    with trace.span("moe.experts"):
        st = r.order // k  # token of each sorted assignment
        keep = r.keep[..., None]
        gathered = torch.where(keep, xt.gather(1, st[..., None].expand(-1, -1, d)), 0)
        # kept slots are unique; a dropped assignment adds exact zeros
        buf = torch.zeros((g, e * cap, d), dtype=xt.dtype, device=xt.device).scatter_add(
            1, r.dst[..., None].expand(-1, -1, d), gathered).reshape(g, e, cap, d)
        del gathered  # the buffers of a long prefill are GBs each: each goes when read

        def run_experts(buf, w_gate, w_up, w_down):
            h = a(torch.einsum("gecd,edf->gecf", buf, w_gate)) * torch.einsum(
                "gecd,edf->gecf", buf, w_up)
            return torch.einsum("gecf,efd->gecd", h, w_down)

        ws = [p[n].to(buf.dtype) for n in ("we_gate", "we_up", "we_down")]
        if constrain_fn is None:
            y = run_experts(buf, *ws)
        else:
            # each device runs its groups through its experts (shard_map-style),
            # the expert weights gathered whole over data (FSDP), as DTensor's
            # einsums would flatten the two sharded dims into a strided shard
            from torch.distributed.tensor.experimental import local_map

            buf = constrain_fn(buf, ("batch", "act_experts", None, None))
            ws = [constrain_fn(w, ("act_experts", None, None)) for w in ws]
            pl = [list(t.placements) for t in (buf, *ws)]
            y = local_map(run_experts, out_placements=pl[0], in_placements=tuple(pl))(buf, *ws)
        y = reshape(y, g, e * cap, d)
        del buf

    with trace.span("moe.combine"):
        sg = r.gate_vals.reshape(g, ng * k).gather(1, r.order)
        yd = y.gather(1, r.dst[..., None].expand(-1, -1, d))  # (G, Ng*k, D)
        contrib = torch.where(keep, yd * sg[..., None].to(y.dtype), 0)
        del y, yd
        # each token's k sorted positions, in ascending expert order
        inv = torch.zeros_like(r.order).scatter(
            1, r.order, torch.arange(ng * k, device=x.device).expand(g, -1).contiguous())
        pos = inv.reshape(g, ng, k).gather(2, torch.argsort(r.expert_idx, dim=-1))
        per_tok = contrib.gather(1, pos.reshape(g, ng * k, 1).expand(-1, -1, d)).reshape(
            g, ng, k, d)
        del contrib
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
    s = dict(tok=ParamSpec((v, cfg.d_model), ("vocab", "embed")))
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, v), ("embed", "vocab"))
    return s


def embed(p, tokens, cfg):
    # F.embedding: the same rows as indexing; its backward on the card is a
    # sorted segment sum, so a train step repeats bit for bit
    return F.embedding(_lookup_ids(tokens, p["tok"]), p["tok"]) * math.sqrt(cfg.d_model)


def _lookup_ids(tokens, table):
    """On a mesh: the token ids gathered whole on each mesh dim where the
    table shards its embedding dim (FSDP) -- the layout DTensor's plan of
    the lookup takes them to anyway.  Done first, because torch's DTensor
    (2.13) builds a vocab-sharded table's lookup mask from the ids' shard
    as it was, so a lookup that gathers them itself fails on real values."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not (isinstance(tokens, DTensor) and isinstance(table, DTensor)):
        return tokens
    want = tuple(Replicate() if isinstance(tp, Shard) and tp.dim != 0 else ip
                 for ip, tp in zip(tokens.placements, table.placements))
    return tokens if want == tuple(tokens.placements) else tokens.redistribute(
        tokens.device_mesh, want)


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
