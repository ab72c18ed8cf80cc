"""Model assembly of the port: config -> param specs -> forward / prefill /
decode, for the dense block kinds ``attn`` and ``local``.

`Model` is an `nn.Module` with one `layers.ParamTree` per layer in an
`nn.ModuleList`.  Its `specs` keep the reference's tree (``embed``,
``seg{i}`` with the scanned groups' leaves stacked on a leading layer
axis, ``final_norm``): `init` draws each stacked leaf with the
reference's per-leaf std (its fan-in quirk included, `ROADMAP.md` §3)
and `load_tree` unstacks it into the layers, so the port computes the
function the reference computes on the same tree.  One card, no
sharding: the reference's mesh, rules and constraints are not ported.

Caches are one ``{k, v}`` dict per layer, updated in place by
`decode_step`.  Block kinds and features outside this slice (``ssm``,
``rglru``, ``xattn``, MoE, patches, encoder-decoder) raise
`NotImplementedError` naming them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig, ParallelConfig

IN_SLICE_KINDS = ("attn", "local")


def _check_in_slice(cfg: ModelConfig) -> None:
    for kind in dict.fromkeys(cfg.layer_kinds):
        if kind not in IN_SLICE_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet (dense "
                f"kinds only: {IN_SLICE_KINDS})")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are not ported yet")
    if cfg.n_patches:
        raise NotImplementedError(f"{cfg.name}: n_patches (VLM) is not ported yet")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: is_encoder_decoder is not ported yet")


# ---------------------------------------------------------------------------
# Block specs per kind
# ---------------------------------------------------------------------------


def block_specs(cfg: ModelConfig) -> dict:
    """The dense block; ``attn`` and ``local`` layers share its params."""
    norm = lambda: L.ParamSpec((cfg.d_model,), init="zeros")
    return dict(norm1=norm(), attn=L.attention_specs(cfg), norm2=norm(),
                mlp=L.mlp_specs(cfg))


# ---------------------------------------------------------------------------
# Segments: scan groups + remainders
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[str, ...]  # block kinds inside one group
    n_groups: int  # scan length (1 => unscanned)
    scanned: bool
    first_layer: int  # global layer index of the segment start


def build_segments(cfg: ModelConfig, scan_layers: bool = True) -> list[Segment]:
    """The reference's scan groups (its unscanned leading dense layers of
    MoE models wait for the MoE slice): one scanned segment of whole
    pattern periods when there are at least two, the rest unscanned."""
    kinds = cfg.layer_kinds
    g = len(cfg.pattern)
    n_full = len(kinds) // g
    segs: list[Segment] = []
    rem_start = 0
    if scan_layers and n_full > 1:
        segs.append(Segment(tuple(cfg.pattern), n_full, True, 0))
        rem_start = n_full * g
    for i in range(rem_start, len(kinds)):
        segs.append(Segment((kinds[i],), 1, False, i))
    return segs


def model_specs(cfg: ModelConfig, segments: list[Segment]) -> dict:
    """The reference's spec tree (scanned segments stacked)."""
    specs: dict = dict(embed=L.embed_specs(cfg))
    for si, seg in enumerate(segments):
        seg_spec = {f"b{i}": block_specs(cfg) for i in range(len(seg.kinds))}
        if seg.scanned:
            seg_spec = L.stack_specs(seg_spec, seg.n_groups)
        specs[f"seg{si}"] = seg_spec
    specs["final_norm"] = L.ParamSpec((cfg.d_model,), init="zeros")
    return specs


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class Model(nn.Module):
    """Specs / init / forward / prefill / decode on one device.

    ``device`` defaults to ``cuda`` and raises without a card unless
    ``"cpu"`` is asked for.  Parameters are fp32 until cast (``.to``);
    each op casts its weights to the activations' dtype, as the reference
    does.  Call `init` or `load_tree` before use: construction allocates
    zeros.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        pc: ParallelConfig | None = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        q_chunk: int = 1024,
        kv_chunk: int = 1024,
        device: "str | torch.device | None" = None,
    ):
        super().__init__()
        _check_in_slice(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.pc = pc or ParallelConfig()
        self.compute_dtype = compute_dtype
        self.segments = build_segments(cfg, self.pc.scan_layers)
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        self.kinds = cfg.layer_kinds
        self.embed = L.ParamTree(L.embed_specs(cfg), dev)
        self.layers = nn.ModuleList(L.ParamTree(block_specs(cfg), dev) for _ in self.kinds)
        self.final_norm = nn.Parameter(
            torch.zeros(cfg.d_model, dtype=torch.float32, device=dev), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # -- specs / init -------------------------------------------------------

    def specs(self) -> dict:
        return model_specs(self.cfg, self.segments)

    def param_shapes(self) -> dict:
        return {path: s.shape for path, s in L.tree_leaves(self.specs())}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random init from ``generator`` (drawn on its device), one stacked
        leaf at a time in sorted path order, with the reference's stds."""
        for path, spec in L.tree_leaves(self.specs()):
            self._assign(path, spec.initializer(generator))
        return self

    @torch.no_grad()
    def load_tree(self, tree) -> "Model":
        """Load a tree in the reference's layout (nested dicts of tensors;
        scanned leaves stacked).  Raises on a missing, extra or mis-shaped
        leaf before anything is written."""
        want = dict(L.tree_leaves(self.specs()))
        got = dict(L.tree_leaves(tree))
        missing = sorted(want.keys() - got.keys())
        extra = sorted(got.keys() - want.keys())
        if missing or extra:
            raise KeyError(f"param tree mismatch: missing {missing}, extra {extra}")
        for path, spec in want.items():
            if tuple(got[path].shape) != spec.shape:
                raise ValueError(
                    f"param {path}: shape {tuple(got[path].shape)} != {spec.shape}")
        for path in want:
            self._assign(path, got[path])
        return self

    def _assign(self, path: str, value: torch.Tensor) -> None:
        head, _, rest = path.partition(".")
        if head == "final_norm":
            self.final_norm.copy_(value)
        elif head == "embed":
            self.embed[rest].copy_(value)
        else:
            seg = self.segments[int(head[3:])]
            block, _, leaf = rest.partition(".")
            i = int(block[1:])
            for g in range(seg.n_groups):
                layer = self.layers[seg.first_layer + g * len(seg.kinds) + i]
                p = layer
                for name in leaf.split("."):
                    p = p[name]
                p.copy_(value[g] if seg.scanned else value)

    # -- block forward (train/prefill) --------------------------------------

    def _block_train(self, p, x, kind: str):
        cfg = self.cfg
        h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        attn_out, kv = L.attention_train(p["attn"], h, cfg, kind, cfg.rope_theta,
                                         q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)
        x = x + attn_out
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg), kv

    # -- public forwards ----------------------------------------------------

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence (teacher-forced) forward -> (logits, moe_aux_loss);
        the aux loss is 0 on the dense path."""
        x = self.backbone(batch)
        logits = L.unembed(self.embed, x, self.cfg)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def backbone(self, batch: dict) -> torch.Tensor:
        """Everything up to (but excluding) the unembedding."""
        x = L.embed(self.embed, batch["tokens"], self.cfg).to(self.compute_dtype)
        for p, kind in zip(self.layers, self.kinds):
            x, _ = self._block_train(p, x, kind)
        return L.rms_norm(x, self.final_norm, self.cfg.norm_eps)

    # -- KV cache / decode ---------------------------------------------------

    def cache_len(self, kind: str, max_seq: int) -> int:
        """Slots of a layer's decode cache: a local layer's ring holds at
        most ``window``."""
        if kind == "local" and self.cfg.window:
            return min(max_seq, self.cfg.window)
        return max_seq

    def cache_shape_for(self, kind: str, batch: int, max_seq: int) -> dict:
        cfg = self.cfg
        shp = (batch, self.cache_len(kind, max_seq), cfg.n_kv_heads, cfg.resolved_head_dim)
        return dict(k=torch.zeros(shp, dtype=self.compute_dtype, device=self.device),
                    v=torch.zeros(shp, dtype=self.compute_dtype, device=self.device))

    def init_cache(self, batch: int, max_seq: int) -> list[dict]:
        return [self.cache_shape_for(k, batch, max_seq) for k in self.kinds]

    def _block_decode(self, p, x, kind, cache, pos: int):
        cfg = self.cfg
        h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        out, cache = L.attention_decode(p["attn"], h, cfg, kind, cfg.rope_theta, cache, pos)
        x = x + out
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg), cache

    def decode_step(self, caches: list[dict], token: torch.Tensor, pos: int):
        """One decode step.  token: (B,) ints on the model's device; pos: the
        host int position, one for the whole batch.  The caches are updated
        in place and returned."""
        x = L.embed(self.embed, token[:, None], self.cfg).to(self.compute_dtype)
        for i, (p, kind) in enumerate(zip(self.layers, self.kinds)):
            x, caches[i] = self._block_decode(p, x, kind, caches[i], pos)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = L.unembed(self.embed, x, self.cfg)
        return logits[:, 0, :], caches

    def prefill(self, batch: dict):
        """Prompt pass: returns (last-position logits, per-layer caches).
        Local layers keep only their last ``window`` keys."""
        cfg = self.cfg
        x = L.embed(self.embed, batch["tokens"], cfg).to(self.compute_dtype)
        caches = []
        for p, kind in zip(self.layers, self.kinds):
            x, (k, v) = self._block_train(p, x, kind)
            if kind == "local" and cfg.window and cfg.window < x.shape[1]:
                k = k[:, -cfg.window:]
                v = v[:, -cfg.window:]
            caches.append(dict(k=k.to(self.compute_dtype), v=v.to(self.compute_dtype)))
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = L.unembed(self.embed, x[:, -1:, :], cfg)
        return logits[:, 0, :], caches
