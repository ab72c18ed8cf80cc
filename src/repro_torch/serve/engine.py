"""Batched serving engine of the port: prefill + decode with cache management.

Handles the cache-layout plumbing between the two phases:
  * global-attention caches are padded from prompt length to max_seq,
  * local-attention ring caches are rotated so entry i holds absolute
    position p with p === i (mod window) -- the invariant decode_step's
    ring addressing relies on,
  * recurrent states (SSD / RG-LRU) and the encoder's cross-attention
    keys and values pass through unchanged.

The caches are one dict per layer (``{k, v}``, ``{k, v, xk, xv}`` or
``{conv, state}``), and `align_prefill_caches` finds the sequence axis
of each entry through the model's `cache_logical` (``kv_seq``), never
from shapes: a window-full ring cache has the SAME shape as its
allocation but still needs rotation whenever prompt_len % window != 0.

A VLM's patch prefix holds the first ``n_patches`` positions of every
cache, so `ServeEngine.generate` aligns to ``max_seq + n_patches`` and
decodes from position ``n_patches + prompt_len``.  Encoder frames and
patches reach the model only through ``generate(..., extra_batch=)``, as
in the reference; `ServeEngine.serve` passes prompts only, so for such a
config it raises a `ValueError` naming the missing input (where the
reference fails with a ``KeyError`` inside prefill).

A lightweight slot-based batcher (continuous-batching lite) serves
variable-length requests on a fixed batch of decode slots.  Prompts are
left-padded with token 0 and the pads are attended (they hold positions
0..pad-1), as in the reference; in a recurrent layer they pass through
the conv and enter the state.

Spans (`runtime.trace`, a no-op unless on): ``engine.wave`` around each
wave of `serve`, ``engine.prefill`` (the prefill and the cache
alignment), and per step ``engine.readback`` (the host's wait for the
step's tokens) and ``engine.decode`` (the decode step and the sampling).
The engine calls ``self.model.prefill`` and ``self.model.decode_step`` by
attribute, so a caller may wrap them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.model import Model
from ..runtime import trace


def align_prefill_caches(model: Model, caches: list[dict], prompt_len: int,
                         max_seq: int, batch: int) -> list[dict]:
    """Pad / rotate prefill caches into decode layout (see module doc)."""
    window = model.cfg.window
    out = []
    for kind, cache in zip(model.kinds, caches):
        logical = model.cache_logical(kind)
        tgt_len = model.cache_len(kind, max_seq)
        ring = kind == "local" and window and tgt_len == window and prompt_len >= window
        fixed = {}
        for name, pre in cache.items():
            if pre.shape[0] != batch:
                raise ValueError(f"cache {name}: batch {pre.shape[0]} != {batch}")
            if "kv_seq" not in logical[name]:
                fixed[name] = pre
                continue
            ax = logical[name].index("kv_seq")
            cur = pre.shape[ax]
            t = pre
            if cur != tgt_len:
                pad = list(pre.shape)
                pad[ax] = tgt_len - cur
                t = torch.cat([pre, pre.new_zeros(pad)], dim=ax)
            if ring and prompt_len % window:
                # full ring: rotate so abs position p sits at slot p % window
                t = torch.roll(t, prompt_len % window, dims=ax)
            fixed[name] = t
        out.append(fixed)
    return out


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (L,) int32
    max_new: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-batch prefill/decode engine with greedy or temperature sampling.

    ``device`` defaults to ``cuda`` (raising without a card unless
    ``"cpu"`` is asked for) and must be the model's.  Sampling at
    ``temperature > 0`` draws from a `torch.Generator` seeded with
    ``seed`` on that device.
    """

    def __init__(self, model: Model, batch: int, max_seq: int,
                 temperature: float = 0.0, seed: int = 0,
                 device: "str | torch.device | None" = None):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model lives on {model.device}, the engine on {dev}")
        self.model = model
        self.device = model.device
        self.batch = batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int,
                 extra_batch: "dict | None" = None) -> np.ndarray:
        """prompts: (B, L) int32 (padded to equal length).  Returns (B, max_new).

        ``extra_batch`` holds the inputs the config reads besides the
        tokens (``frames`` (B, enc_seq, d_model) for an encoder-decoder,
        ``patches`` (B, n_patches, d_model) for a VLM), arrays or tensors; they are
        moved to the engine's device.  One host sync per step: the
        read-back of that step's tokens."""
        b, plen = prompts.shape
        if b != self.batch:
            raise ValueError(f"prompts carry {b} rows for a batch of {self.batch}")
        batch = dict(tokens=torch.as_tensor(np.asarray(prompts, np.int64), device=self.device))
        for name, x in (extra_batch or {}).items():
            batch[name] = torch.as_tensor(x, device=self.device)
        trace.next_wave()
        with trace.span("engine.prefill"):
            logits, caches = self.model.prefill(batch)
            n_patches = self.model.cfg.n_patches or 0
            caches = align_prefill_caches(self.model, caches, plen + n_patches,
                                          self.max_seq + n_patches, batch=b)

        out = np.zeros((b, max_new), np.int32)
        tok = self._sample(logits)
        for t in range(max_new):
            with trace.span("engine.readback", t=t):
                out[:, t] = tok.cpu().numpy()
            if t == max_new - 1:
                break
            with trace.span("engine.decode", t=t):
                logits, caches = self.model.decode_step(caches, tok, n_patches + plen + t)
                tok = self._sample(logits)
        return out

    # -- slot-based continuous batching (lite) -------------------------------

    def serve(self, requests: list[Request], prompt_pad: int) -> list[Request]:
        """Serve a request list on ``self.batch`` slots, refilling slots as
        requests finish (waves of prefill + shared decode steps).

        Every prompt must satisfy ``1 <= len(prompt) <= prompt_pad``; a
        violating request raises `ValueError` up front (naming the uid)
        rather than surfacing as a numpy broadcast error mid-wave.  So does
        a config that reads frames or patches: serve passes prompts only
        (use ``generate(..., extra_batch=)``).
        """
        cfg = self.model.cfg
        missing = [n for n, needed in (("frames", cfg.is_encoder_decoder),
                                       ("patches", cfg.n_patches)) if needed]
        if missing:
            raise ValueError(
                f"{cfg.name} reads {', '.join(missing)} besides the prompts, and "
                f"serve() passes prompts only: call generate(prompts, max_new, "
                f"extra_batch={{{', '.join(repr(m) + ': ...' for m in missing)}}})")
        for r in requests:
            if not 0 < len(r.prompt) <= prompt_pad:
                raise ValueError(
                    f"request uid={r.uid}: prompt length {len(r.prompt)} "
                    f"must be in [1, prompt_pad={prompt_pad}]"
                )
        queue = list(requests)
        done: list[Request] = []
        while queue:
            wave = queue[: self.batch]
            queue = queue[len(wave):]
            prompts = np.zeros((self.batch, prompt_pad), np.int32)
            for i, r in enumerate(wave):
                prompts[i, prompt_pad - len(r.prompt):] = r.prompt  # left-pad
            max_new = max(r.max_new for r in wave)
            attrs = None
            if trace.active():
                attrs = dict(uids=[r.uid for r in wave], max_new=[r.max_new for r in wave])
            with trace.span("engine.wave", attrs):
                toks = self.generate(prompts, max_new)
            for i, r in enumerate(wave):
                r.out_tokens = list(toks[i, : r.max_new])
                r.done = True
                done.append(r)
        return done
