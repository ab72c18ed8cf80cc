"""Model assembly of the port: config -> param specs -> forward / prefill /
decode, for the decoder-only block kinds ``attn``, ``local`` (dense or
MoE FFN), ``ssm`` (Mamba-2) and ``rglru`` (RG-LRU).

`Model` is an `nn.Module` with one `layers.ParamTree` per layer in an
`nn.ModuleList`.  Its `specs` keep the reference's tree (``embed``,
``seg{i}`` with the scanned groups' leaves stacked on a leading layer
axis, ``final_norm``): `init` draws each stacked leaf with the
reference's per-leaf std (its fan-in quirk included, `ROADMAP.md` §3)
and `load_tree` unstacks it into the layers, so the port computes the
function the reference computes on the same tree.  One card, no
sharding: the reference's mesh, rules and constraints are not ported,
and the MoE dispatch runs as one group (the reference's
``_moe_groups()`` without a mesh).

Caches are one dict per layer, updated in place by `decode_step`:
``{k, v}`` for attention, ``{conv, state}`` for the recurrent kinds (the
state fp32).  Cross-attention, the encoder and image patches raise
`NotImplementedError` naming them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from . import ssm as S
from .config import ModelConfig, ParallelConfig

IN_SLICE_KINDS = ("attn", "local", "ssm", "rglru")
RECURRENT_KINDS = ("ssm", "rglru")

#: Leaves the ops read in fp32 without casting them to the activations'
#: dtype (``ssm.py``): they stay fp32 in a model cast to bf16, where
#: every other param takes the cast.
FP32_PARAMS = frozenset({
    "ssm.a_log", "ssm.dt_bias", "ssm.d_skip",
    "rglru.wa", "rglru.ba", "rglru.wx", "rglru.bx", "rglru.lam",
})


def keeps_fp32(name: str) -> bool:
    """Whether the param at dotted path ``name`` (a layer's, or the
    model's ``layers.<i>.``-prefixed one) is in `FP32_PARAMS`."""
    return any(name == leaf or name.endswith("." + leaf) for leaf in FP32_PARAMS)


def _check_in_slice(cfg: ModelConfig) -> None:
    for kind in dict.fromkeys(cfg.layer_kinds):
        if kind not in IN_SLICE_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet (ported "
                f"kinds: {IN_SLICE_KINDS})")
    if cfg.n_patches:
        raise NotImplementedError(f"{cfg.name}: n_patches (VLM) is not ported yet")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: is_encoder_decoder is not ported yet")


# ---------------------------------------------------------------------------
# Block specs per kind
# ---------------------------------------------------------------------------


def block_specs(cfg: ModelConfig, kind: str, layer_idx: int = 10**9) -> dict:
    """A layer's params by block kind; an attention layer of an MoE model
    has ``moe`` in place of ``mlp`` from ``first_dense_layers`` on."""
    norm = lambda: L.ParamSpec((cfg.d_model,), init="zeros")
    if kind in ("attn", "local"):
        s = dict(norm1=norm(), attn=L.attention_specs(cfg), norm2=norm())
        if cfg.is_moe and layer_idx >= cfg.first_dense_layers:
            s["moe"] = L.moe_specs(cfg)
        else:
            s["mlp"] = L.mlp_specs(cfg)
        return s
    if kind == "ssm":
        return dict(norm1=norm(), ssm=S.mamba2_specs(cfg))
    if kind == "rglru":
        return dict(norm1=norm(), rglru=S.rglru_specs(cfg), norm2=norm(),
                    mlp=L.mlp_specs(cfg))
    raise ValueError(f"unknown block kind {kind}")


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
    """The reference's scan groups: the leading dense layers of MoE models
    unscanned, then one scanned segment of whole pattern periods when
    there are at least two, the rest unscanned."""
    kinds = cfg.layer_kinds
    g = len(cfg.pattern)
    segs: list[Segment] = []
    start = 0
    if cfg.is_moe and cfg.first_dense_layers:
        for i in range(cfg.first_dense_layers):
            segs.append(Segment((kinds[i],), 1, False, i))
        start = cfg.first_dense_layers
    n_full = (len(kinds) - start) // g
    rem_start = start
    if scan_layers and n_full > 1:
        segs.append(Segment(tuple(cfg.pattern), n_full, True, start))
        rem_start = start + n_full * g
    for i in range(rem_start, len(kinds)):
        segs.append(Segment((kinds[i],), 1, False, i))
    return segs


def model_specs(cfg: ModelConfig, segments: list[Segment]) -> dict:
    """The reference's spec tree (scanned segments stacked)."""
    specs: dict = dict(embed=L.embed_specs(cfg))
    for si, seg in enumerate(segments):
        seg_spec = {f"b{i}": block_specs(cfg, k, seg.first_layer + i)
                    for i, k in enumerate(seg.kinds)}
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
    ``"cpu"`` is asked for.  Parameters are allocated in ``param_dtype``
    (fp32 by default) apart from `FP32_PARAMS`, which stay fp32; each op
    casts its weights to the activations' dtype, as the reference does.
    Call `init` or `load_tree` before use: construction allocates zeros.
    A bf16 model is built as ``Model(..., param_dtype=torch.bfloat16)``
    followed by `init`, which draws each leaf in fp32 and casts it on the
    way in, so it equals an fp32 `init` followed by `cast` without ever
    holding the whole fp32 model.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        pc: ParallelConfig | None = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        q_chunk: int = 1024,
        kv_chunk: int = 1024,
        device: "str | torch.device | None" = None,
        param_dtype: torch.dtype = torch.float32,
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
        self.embed = L.ParamTree(L.embed_specs(cfg), dev, param_dtype)
        self.layers = nn.ModuleList(
            L.ParamTree(block_specs(cfg, kind, i), dev, param_dtype, FP32_PARAMS)
            for i, kind in enumerate(self.kinds))
        self.final_norm = nn.Parameter(
            torch.zeros(cfg.d_model, dtype=param_dtype, device=dev), requires_grad=False)

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
    def cast(self, dtype: torch.dtype) -> "Model":
        """Cast every param to ``dtype`` except `FP32_PARAMS`."""
        for name, p in self.named_parameters():
            if not keeps_fp32(name):
                p.data = p.data.to(dtype)
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
        """One block over the whole sequence -> (x, prefill cache, MoE aux
        loss or None).  The cache is ``(k, v)`` un-repeated for attention,
        ``dict(conv, state)`` for the recurrent kinds."""
        cfg = self.cfg
        h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        if kind in ("attn", "local"):
            out, cache = L.attention_train(p["attn"], h, cfg, kind, cfg.rope_theta,
                                           q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)
        elif kind == "ssm":
            out, cache = S.mamba2_forward(p["ssm"], h, cfg)
            return x + out, cache, None
        elif kind == "rglru":
            out, cache = S.rglru_forward(p["rglru"], h, cfg)
        else:
            raise ValueError(kind)
        x = x + out
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        aux = None
        if "moe" in p:
            ff, aux = L.moe_ffn(p["moe"], h, cfg)
        else:
            ff = L.mlp(p["mlp"], h, cfg)
        return x + ff, cache, aux

    # -- public forwards ----------------------------------------------------

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence (teacher-forced) forward -> (logits, moe_aux_loss);
        the aux loss sums over the MoE layers (0 without any)."""
        x, aux = self.backbone(batch)
        return L.unembed(self.embed, x, self.cfg), aux

    def backbone(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Everything up to (but excluding) the unembedding -> (x, aux)."""
        x = L.embed(self.embed, batch["tokens"], self.cfg).to(self.compute_dtype)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, kind in zip(self.layers, self.kinds):
            x, _, aux = self._block_train(p, x, kind)
            if aux is not None:
                aux_total = aux_total + aux
        return L.rms_norm(x, self.final_norm, self.cfg.norm_eps), aux_total

    # -- KV cache / decode ---------------------------------------------------

    def cache_len(self, kind: str, max_seq: int) -> int:
        """Slots of an attention layer's decode cache: a local layer's ring
        holds at most ``window``."""
        if kind == "local" and self.cfg.window:
            return min(max_seq, self.cfg.window)
        return max_seq

    def cache_shape_for(self, kind: str, batch: int, max_seq: int) -> dict:
        cfg = self.cfg
        zeros = lambda *shp, dtype=self.compute_dtype: torch.zeros(
            shp, dtype=dtype, device=self.device)
        if kind in ("attn", "local"):
            shp = (batch, self.cache_len(kind, max_seq), cfg.n_kv_heads, cfg.resolved_head_dim)
            return dict(k=zeros(*shp), v=zeros(*shp))
        if kind == "ssm":
            di = cfg.d_inner or 2 * cfg.d_model
            n = cfg.ssm_state
            nh = di // cfg.ssm_head_dim
            return dict(conv=zeros(batch, cfg.conv_width - 1, di + 2 * n),
                        state=zeros(batch, nh, cfg.ssm_head_dim, n, dtype=torch.float32))
        if kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            return dict(conv=zeros(batch, cfg.conv_width - 1, w),
                        state=zeros(batch, w, dtype=torch.float32))
        raise ValueError(kind)

    def init_cache(self, batch: int, max_seq: int) -> list[dict]:
        return [self.cache_shape_for(k, batch, max_seq) for k in self.kinds]

    def _block_decode(self, p, x, kind, cache, pos: int):
        cfg = self.cfg
        h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        if kind in ("attn", "local"):
            out, cache = L.attention_decode(p["attn"], h, cfg, kind, cfg.rope_theta, cache, pos)
        elif kind == "ssm":
            out, cache = S.mamba2_decode(p["ssm"], h, cfg, cache)
            return x + out, cache
        elif kind == "rglru":
            out, cache = S.rglru_decode(p["rglru"], h, cfg, cache)
        else:
            raise ValueError(kind)
        x = x + out
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        if "moe" in p:
            ff, _ = L.moe_ffn(p["moe"], h, cfg)
        else:
            ff = L.mlp(p["mlp"], h, cfg)
        return x + ff, cache

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
        Local layers keep only their last ``window`` keys; recurrent layers
        keep their conv inputs and final fp32 state."""
        cfg = self.cfg
        x = L.embed(self.embed, batch["tokens"], cfg).to(self.compute_dtype)
        caches = []
        for p, kind in zip(self.layers, self.kinds):
            x, cache, _ = self._block_train(p, x, kind)
            if kind in RECURRENT_KINDS:
                caches.append(cache)
                continue
            k, v = cache
            if kind == "local" and cfg.window and cfg.window < x.shape[1]:
                k = k[:, -cfg.window:]
                v = v[:, -cfg.window:]
            caches.append(dict(k=k.to(self.compute_dtype), v=v.to(self.compute_dtype)))
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = L.unembed(self.embed, x[:, -1:, :], cfg)
        return logits[:, 0, :], caches
