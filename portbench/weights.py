"""Random weights of a cell, drawn on the device from the seed.

One `torch.randn` call per kind of leaf, stacked over the layers that hold
it, in the fixed order of the architecture's ``kinds`` (`kinds` here for
the decoder), on a generator seeded from ``--seed``.
Drawing again with the same seed on the same device gives the same values,
so the program is loaded from one draw and the reference makes its own
once the program has been freed: it takes nothing the program made.

Scales: every matrix is N(0, 1 / fan_in) with fan_in its input width, so
activations stay of order one through the depth; the norms' gains (applied
as ``1 + g``) are normal with std 0.1.  The embedding table's entries have
std ``tok_scale / sqrt(d_model)`` (a workload's ``weights.tok_scale``, 1 by
default): with the table tied to the unembedding, a token fed back adds
``sqrt(d_model) * tok_scale / (rms of the blocks' sum)`` standard
deviations to its own next logit, and at 1 that makes a served model
repeat one token with a wide margin, where no precision changes the
choice.  A serving cell of a tied model takes a small scale so that its
logits are Gaussian over the vocabulary given the hidden state; an untied
head (its own N(0, 1 / d_model) matrix) needs none.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch

from . import arch
from .arch import Arch



def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` ("weights", "traffic", ...) of ``--seed``."""
    words = [int(b) for b in stream.encode()]
    ss = np.random.SeedSequence([seed & (2**64 - 1), seed >> 64, *words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def kinds(a: Arch, tok_scale: float = 1.0) -> list[tuple[str, tuple[int, ...], float]]:
    """The decoder's ``(kind, stacked shape, std)`` of every kind of leaf, in
    draw order.  Per-layer kinds lead with the number of layers that hold
    them."""
    d, hd, L = a.d_model, a.head_dim, a.n_layers
    out = [
        ("tok", (a.padded_vocab, d), tok_scale / math.sqrt(d)),
        ("final_norm", (d,), 0.1),
        ("norm1", (L, d), 0.1),
        ("norm2", (L, d), 0.1),
        ("wq", (L, d, a.n_heads * hd), 1 / math.sqrt(d)),
        ("wk", (L, d, a.n_kv_heads * hd), 1 / math.sqrt(d)),
        ("wv", (L, d, a.n_kv_heads * hd), 1 / math.sqrt(d)),
        ("wo", (L, a.n_heads * hd, d), 1 / math.sqrt(a.n_heads * hd)),
    ]
    ld, f = a.dense_layers, a.d_ff
    if ld:
        out += [("w_gate", (ld, d, f), 1 / math.sqrt(d)),
                ("w_up", (ld, d, f), 1 / math.sqrt(d)),
                ("w_down", (ld, f, d), 1 / math.sqrt(f))]
    lm, e, fe = a.moe_layers, a.n_experts, a.moe_d_ff
    if lm:
        out += [("router", (lm, d, e), 1 / math.sqrt(d)),
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


def draw(a, seed: int, device, dtype: torch.dtype,
         tok_scale: float = 1.0) -> Iterator[tuple[str, torch.Tensor]]:
    """``(kind, stacked tensor)`` in the order of ``a``'s architecture's
    ``kinds``; each is drawn when asked for, so a caller that copies and
    drops it holds one at a time."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    for kind, shape, std in arch.module(a).kinds(a, tok_scale):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        yield kind, t.mul_(std)


def leaves(a) -> Iterator[tuple[str, str, int | None]]:
    """``(key, kind, index)`` of every leaf the program keeps: a global kind
    of ``a``'s architecture (its ``GLOBAL``) once (index None), a stacked
    kind once for each layer that holds it."""
    mod = arch.module(a)
    for kind, shape, _ in mod.kinds(a):
        if kind in mod.GLOBAL:
            yield kind, kind, None
        else:
            for i in range(shape[0]):
                yield f"{kind}.{i}", kind, i
