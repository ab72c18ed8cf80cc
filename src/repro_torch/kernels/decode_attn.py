"""Decode attention as one hand kernel: RoPE, cache append and attention
over the cache, in place (``csrc/decode_attn.cu``).

`decode_attention` takes one decode step's projections of one attention
layer before RoPE -- q (B, 1, H, D), the new k and v (B, 1, KV, D) -- the
layer's KV cache (B, S, KV, D) each, RoPE's inverse frequencies and the
step's position, and the slots to attend: ``n_valid`` of them from
``first`` on, modulo S, the newest last (where the new k and v go).  It
writes k after RoPE and v into that slot and returns the attention's
output (B, 1, H, D) in the cache's dtype.  The query heads of a KV head
are its ``H // KV`` neighbours (``n_rep``, the GQA grouping).

The plain version is the eager code it replaces,
`repro_torch.models.layers.decode_attend`, which the CPU runs (and the mesh
path, on DTensors); `models.layers.attention_decode` chooses.  Here a CUDA
tensor launches the kernel, or the call raises (`build.OperandError` for
operands the kernel does not take, `build.KernelError` for a failed
launch); there is no fallback.  ``LAUNCHES`` counts the calls that
launched (one or, for a split row, two kernels each): a view of the
registry's one counter.

Where the scores of a row do not fit shared memory, or the batch times KV
heads gives fewer than `WAVES` waves of blocks, `plan` splits the valid
slots into chunks (its choice reads only the shapes and the card's SM
count).  `tolerance` states how far the kernel's output may lie from the
plain version's, and `prefetch` starts the build in the background.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..analysis import registry as _registry
from . import build

# repro: kernel-module — host syncs in device-adjacent code are annotated
#: Calls that launched the kernel (the plain version's runs do not count).
LAUNCHES = _registry.CounterView(("decode_attn",))
_registry.register_counter("decode_attn", __name__)

#: The cache dtypes the kernel is built for (bf16 serves, fp32 checks).
DTYPES = (torch.bfloat16, torch.float32)
#: Head sizes it takes: a row is whole 16-byte vectors, a power of two of them.
HEAD_DIMS = (16, 32, 64, 128, 256)
#: Threads a block aims at (on the H100 128 beat 256 and 512 at both serving
#: cells' shapes: 0.212 / 0.242 / 0.233 ms and 0.235 / 0.232 / 0.258 ms a
#: layer), and the most it may have (`csrc`'s MAX_THREADS).
THREADS, MAX_THREADS = 128, 512
#: The fp32 scores of one chunk a block holds in shared memory, at most.
SCORE_BYTES = 64 * 1024
#: Slots of a chunk at least, where a row is split only to fill the card.
MIN_CHUNK = 64
#: Waves of blocks over the card's SMs below which a row is split to fill
#: it (0: split only rows whose scores outgrow `SCORE_BYTES`).
WAVES = 2


def prefetch() -> None:
    """Start building the kernel in the background (`build.prefetch`)."""
    build.prefetch("decode_attn")


def tolerance(want: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """How far, element by element, the kernel's output may lie from the
    plain version's output ``want`` on the same operands (``v_cache``: the
    values attended).  The two sum scores, softmax and values in other
    orders, so their fp32 sums differ in the last fp32 places, and each
    rounds its output once to the cache dtype.  In bf16 the outputs may
    then land on neighbouring values, one unit in the last place apart,
    which is at most 2^-7 of either.  A probability may also round to its
    neighbouring bf16 value, which moves an output by 2^-7 of that
    probability times its value: rare, as the two fp32 softmaxes agree to
    a few fp32 units, and over hundreds of slots under half a unit of a
    typical output; 2^-8 of the mean |want| bounds their sum.  In fp32
    nothing rounds in bf16: four units in the last place of the largest
    |v| (each output is a convex sum of v's rows)."""
    w = want.float().abs()
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * w + 2.0 ** -8 * w.mean()
    return (4 * 2.0 ** -23 * v_cache.abs().amax().float()).expand_as(w)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("decode_attn")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attn.argtypes = [ci, vp, vp, vp, vp, vp, ll, ll, ll, ll, vp, vp, vp,
                                ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, vp]
    lib.decode_attn.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(batch: int, kv_heads: int, n_rep: int, head_dim: int, itemsize: int, n_valid: int,
         n_sm: int) -> tuple[int, int, int]:
    """``(threads, n_split, chunk)`` of a launch: a block of whole rows of
    ``n_rep * tpr`` threads (``tpr`` 16-byte slices of a row a head, at most
    32) and whole warps; the valid slots in ``n_split`` chunks of ``chunk``
    (the last may be shorter, none is empty).  A row is split where its
    scores outgrow `SCORE_BYTES`, or where ``batch * kv_heads`` blocks make
    fewer than `WAVES` waves of ``n_sm`` (then into chunks of `MIN_CHUNK`
    slots at least)."""
    tpr = min(32, head_dim * itemsize // 16)
    team = n_rep * tpr
    unit = team * 32 // math.gcd(team, 32)
    if unit > MAX_THREADS:
        raise build.OperandError(
            f"decode_attention: {n_rep} query heads a KV head at head_dim {head_dim} need "
            f"blocks of {unit} threads, more than {MAX_THREADS}")
    threads = unit * max(1, THREADS // unit)
    blocks = batch * kv_heads
    want = max(-(-n_rep * n_valid * 4 // SCORE_BYTES),
               min(-(-WAVES * n_sm // blocks), -(-n_valid // MIN_CHUNK)))
    chunk = -(-n_valid // want)
    return threads, -(-n_valid // chunk), chunk


def check_operands(q, k_new, v_new, k_cache, v_cache, inv_freq, pos: int, first: int,
                   n_valid: int) -> None:
    """Raise `build.OperandError` for operands the kernel does not take:
    dtypes, shapes, layouts (each slot of a cache a contiguous (KV, D)
    block, its strides and start on 16-byte vectors), devices and the
    slots."""
    dt = k_cache.dtype
    if dt not in DTYPES:
        raise build.OperandError(f"decode_attention: cache dtype {dt} (takes {DTYPES})")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new), ("v_cache", v_cache)):
        if t.dtype != dt:
            raise build.OperandError(f"decode_attention: {name} is {t.dtype}, the cache {dt}")
    if inv_freq.dtype != torch.float32:
        raise build.OperandError(f"decode_attention: inv_freq is {inv_freq.dtype}, not fp32")
    shape = k_cache.shape
    if len(shape) != 4 or v_cache.shape != shape:
        raise build.OperandError(f"decode_attention: caches {tuple(shape)} and "
                                 f"{tuple(v_cache.shape)}, not two equal (B, S, KV, D)")
    b, s, kv, d = shape
    if d not in HEAD_DIMS:
        raise build.OperandError(f"decode_attention: head_dim {d} (takes {HEAD_DIMS})")
    qb, one, h, qd = q.shape if q.dim() == 4 else (None,) * 4
    if (qb, one, qd) != (b, 1, d) or h % kv:
        raise build.OperandError(f"decode_attention: q {tuple(q.shape)} against a cache of "
                                 f"{b} sequences, {kv} KV heads of {d}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (b, 1, kv, d):
            raise build.OperandError(f"decode_attention: {name} {tuple(t.shape)}, not "
                                     f"{(b, 1, kv, d)}")
    if inv_freq.shape != (d // 2,):
        raise build.OperandError(f"decode_attention: inv_freq {tuple(inv_freq.shape)}, not "
                                 f"{(d // 2,)}")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new), ("inv_freq", inv_freq)):
        if not t.is_contiguous():
            raise build.OperandError(f"decode_attention: {name} is not contiguous")
    vec = 16 // k_cache.element_size()
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        sb, ss, sk, sd = t.stride()
        if sd != 1 or sk != d or ss % vec or sb % vec or t.data_ptr() % 16:
            raise build.OperandError(
                f"decode_attention: {name} strides {t.stride()}: each slot's (KV, D) must be "
                "contiguous, the slot and batch strides and the start on 16-byte vectors")
    if not (0 < n_valid <= s and 0 <= first < s and pos >= 0):
        raise build.OperandError(f"decode_attention: {n_valid} slots from {first} at position "
                                 f"{pos} in a cache of {s}")
    devs = {t.get_device() for t in (q, k_new, v_new, k_cache, v_cache, inv_freq)}
    if len(devs) != 1:
        raise build.OperandError(f"decode_attention: operands on devices {sorted(devs)} "
                                 "(-1: the CPU)")


def decode_attention(q, k_new, v_new, k_cache, v_cache, inv_freq, pos: int, first: int,
                     n_valid: int, scale: float) -> torch.Tensor:
    """One decode step of one layer (see module doc); ``scale`` multiplies
    q after RoPE.  The caches are written in place."""
    check_operands(q, k_new, v_new, k_cache, v_cache, inv_freq, pos, first, n_valid)
    dev = k_cache.device
    if dev.type != "cuda":
        raise build.OperandError(
            f"decode_attention: the kernel takes CUDA tensors, not {dev.type} (the plain "
            "version is models.layers.decode_attend)")
    b, s, kv, d = k_cache.shape
    n_rep = q.shape[2] // kv
    threads, n_split, chunk = plan(b, kv, n_rep, d, k_cache.element_size(), n_valid,
                                   _sm_count(dev.index))
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    scratch = None
    if n_split > 1:  # scores, chunk stats, partial sums and tickets (csrc's layout)
        rows = b * kv * n_rep
        scratch = torch.empty(rows * (n_valid + n_split * (2 + d)) + b * kv,
                              dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().decode_attn(
            int(k_cache.dtype == torch.float32), q.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_cache.stride(0),
            k_cache.stride(1), v_cache.stride(0), v_cache.stride(1), inv_freq.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, kv, n_rep, d,
            pos, first, n_valid, s, n_split, chunk, scale, threads,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "decode_attn")
    LAUNCHES["decode_attn"] += 1
    return out
