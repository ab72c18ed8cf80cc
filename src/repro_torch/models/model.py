"""Model assembly of the port: config -> param specs -> forward / loss /
prefill / decode, for every block kind of the zoo: ``attn``, ``local``
and ``mla`` (multi-head latent attention; each with a dense or MoE FFN),
``ssm`` (Mamba-2), ``rglru`` (RG-LRU), ``xattn`` (a
decoder block with cross-attention over the encoder, whisper) and the
bidirectional ``enc`` blocks of the encoder, plus the image-patch prefix
of a VLM (internvl2).

`Model` is an `nn.Module` with one `layers.ParamTree` per layer in an
`nn.ModuleList` (and the ``encoder`` tree and ``patch_proj`` where the
config has them).  Its `specs` keep the reference's tree (``embed``,
``seg{i}`` with the scanned groups' leaves stacked on a leading layer
axis, ``final_norm``, ``encoder``, ``patch_proj``): `init` draws each
stacked leaf with the reference's per-leaf std (its fan-in quirk
included, `ROADMAP.md` §3) and `load_tree` unstacks it into the layers,
so the port computes the function the reference computes on the same
tree; `to_tree` / `from_tree` carry a flat dict keyed like
``named_parameters`` (params, grads, optimizer moments) to and from that
layout.

On a mesh (``mesh=`` a `DeviceMesh`, ``rules=`` the logical-axis table of
`parallel.sharding`) every param is a DTensor placed by its spec's logical
axes, the activations are redistributed at the reference's sharding
constraints, and the MoE dispatch runs one group per data shard; the
dry-run (`launch.dryrun`) traces the steps this way on ``meta`` over a fake
process group, under ``implicit_replication`` (the plain tensors the model
makes -- positions, masks, zero buffers -- join as replicated).  Without a
mesh nothing of this runs: one device, one MoE group.

Caches are one dict per layer, updated in place by `decode_step`:
``{k, v}`` for attention, ``{c, kr}`` for ``mla`` (the normed latent and
the rotary key), ``{k, v, xk, xv}`` for ``xattn`` (the encoder's
cross-attention keys and values, filled once at prefill), ``{conv,
state}`` for the recurrent kinds (the state fp32).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import resolve_device
from ..parallel import sharding as sh
from ..runtime import trace
from . import layers as L
from . import ssm as S
from .config import ModelConfig, ParallelConfig

BLOCK_KINDS = ("attn", "local", "mla", "ssm", "rglru", "xattn", "enc")
RECURRENT_KINDS = ("ssm", "rglru")
#: the kinds whose decode attention is the hand kernel (`layers.attention_decode`)
KERNEL_KINDS = ("attn", "local", "xattn")

#: the residual stream between blocks: batch over data, sequence over model
#: where it divides (the reference's sequence-parallel constraint)
SEQ_SHARD = ("batch", "act_seq_shard", None)
#: a block's normed input on a mesh: the sequence whole on every device
GATHERED = ("batch", None, None)

#: Leaves the ops read in fp32 without casting them to the activations'
#: dtype (``ssm.py``): they stay fp32 in a model cast to bf16, where
#: every other param takes the cast.
FP32_PARAMS = frozenset({
    "ssm.a_log", "ssm.dt_bias", "ssm.d_skip",
    "rglru.wa", "rglru.ba", "rglru.wx", "rglru.bx", "rglru.lam",
    "moe.router_bias",
})


def keeps_fp32(name: str) -> bool:
    """Whether the param at dotted path ``name`` (a layer's, or the
    model's ``layers.<i>.``-prefixed one) is in `FP32_PARAMS`."""
    return any(name == leaf or name.endswith("." + leaf) for leaf in FP32_PARAMS)


def _check_kinds(cfg: ModelConfig, mesh) -> None:
    for kind in dict.fromkeys(cfg.layer_kinds):
        if kind not in BLOCK_KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r} (kinds: {BLOCK_KINDS})")
    if mesh is not None and "mla" in cfg.layer_kinds:
        raise NotImplementedError(
            f"{cfg.name}: the mesh path does not run the 'mla' block kind; build the model "
            f"without a mesh")


# ---------------------------------------------------------------------------
# Block specs per kind
# ---------------------------------------------------------------------------


def block_specs(cfg: ModelConfig, kind: str, layer_idx: int = 10**9) -> dict:
    """A layer's params by block kind; an attention layer of an MoE model
    has ``moe`` in place of ``mlp`` from ``first_dense_layers`` on."""
    norm = lambda: L.ParamSpec((cfg.d_model,), (None,), init="zeros")
    if kind in ("attn", "local", "mla"):
        attn = L.mla_specs(cfg) if kind == "mla" else L.attention_specs(cfg)
        s = dict(norm1=norm(), attn=attn, norm2=norm())
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
    if kind == "xattn":  # decoder block with cross-attention (whisper)
        return dict(norm1=norm(), attn=L.attention_specs(cfg),
                    norm_x=norm(), xattn=L.cross_attention_specs(cfg),
                    norm2=norm(), mlp=L.mlp_specs(cfg))
    if kind == "enc":  # bidirectional encoder block
        return dict(norm1=norm(), attn=L.attention_specs(cfg), norm2=norm(),
                    mlp=L.mlp_specs(cfg))
    raise ValueError(f"unknown block kind {kind}")


def encoder_specs(cfg: ModelConfig) -> dict:
    """The encoder's ``b{i}`` blocks (unscanned), final norm and learned
    positions over the ``enc_seq`` frames."""
    enc: dict = {f"b{i}": block_specs(cfg, "enc") for i in range(cfg.n_enc_layers)}
    enc["norm"] = L.ParamSpec((cfg.d_model,), (None,), init="zeros")
    enc["pos_embed"] = L.ParamSpec((cfg.enc_seq, cfg.d_model), (None, "embed"), scale=0.02)
    return enc


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
    specs["final_norm"] = L.ParamSpec((cfg.d_model,), (None,), init="zeros")
    if cfg.is_encoder_decoder:
        specs["encoder"] = encoder_specs(cfg)
    if cfg.n_patches:
        specs["patch_proj"] = L.ParamSpec((cfg.d_model, cfg.d_model), ("embed", None))
    return specs


def _nest(flat: Mapping[str, torch.Tensor]) -> dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    out: dict = {}
    for path, t in flat.items():
        *parents, leaf = path.split(".")
        d = out
        for k in parents:
            d = d.setdefault(k, {})
        d[leaf] = t
    return out


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="block"``: keep the outputs of the matmuls without batch
    dims (the reference's ``dots_with_no_batch_dims_saveable``: ``x @ W``
    lowers to ``mm``), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class Model(nn.Module):
    """Specs / init / forward / loss / prefill / decode on one device.

    ``device`` defaults to ``cuda`` and raises without a card unless
    ``"cpu"`` is asked for.  Parameters are allocated in ``param_dtype``
    (fp32 by default) apart from `FP32_PARAMS`, which stay fp32; each op
    casts its weights to the activations' dtype, as the reference does.
    Call `init` or `load_tree` before use: construction allocates zeros.
    A bf16 model is built as ``Model(..., param_dtype=torch.bfloat16)``
    followed by `init`, which draws each leaf in fp32 and casts it on the
    way in, so it equals an fp32 `init` followed by `cast` without ever
    holding the whole fp32 model.

    An encoder-decoder config reads ``batch["frames"]`` (B, enc_seq,
    d_model), a VLM config ``batch["patches"]`` (B, n_patches, d_model):
    precomputed embeddings, the reference's frontend stubs.  A batch
    without them raises `ValueError` naming the input.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        pc: ParallelConfig | None = None,
        mesh=None,
        rules: "dict | None" = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        q_chunk: int = 1024,
        kv_chunk: int = 1024,
        device: "str | torch.device | None" = None,
        param_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        _check_kinds(cfg, mesh)
        dev = resolve_device(device, allow_meta=True)
        self.cfg = cfg
        self.pc = pc or ParallelConfig()
        self.mesh = mesh
        if mesh is not None and rules is None:
            rules = sh.rules_for_model(cfg, self.pc, mesh)
        self.rules = rules
        self.compute_dtype = compute_dtype
        self.segments = build_segments(cfg, self.pc.scan_layers)
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        self.kinds = cfg.layer_kinds
        #: each layer's span attributes, built once (`runtime.trace`)
        self._span_attrs = [dict(layer=i, kind=k) for i, k in enumerate(self.kinds)]
        place = None
        if mesh is not None:
            place = lambda spec, dt: sh.sharded_zeros(
                mesh, spec.shape, sh.spec_for(mesh, spec.shape, spec.logical, rules), dt, dev)
        tree = lambda specs, fp32=frozenset(): L.ParamTree(specs, dev, param_dtype, fp32,
                                                           place=place)
        top = model_specs(cfg, [])  # the leaves outside the layer stack
        self.embed = tree(top["embed"])
        self.layers = nn.ModuleList(
            tree(block_specs(cfg, kind, i), FP32_PARAMS) for i, kind in enumerate(self.kinds))
        leaf = lambda name: tree({name: top[name]})[name]
        self.final_norm = leaf("final_norm")
        self.encoder = tree(top["encoder"]) if cfg.is_encoder_decoder else None
        self.patch_proj = leaf("patch_proj") if cfg.n_patches else None

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # -- constraints --------------------------------------------------------

    def _constrain(self, x, logical):
        if self.mesh is None or self.rules is None:
            return x
        return sh.constrain(x, self.mesh, logical, self.rules)

    def _norm(self, x, gamma):
        """`rms_norm` of the residual stream, then (on a mesh) its sequence
        gathered: Megatron-SP's all-gather ahead of a block's projections,
        which GSPMD inserts on its own.  DTensor would instead flatten the
        seq-sharded (B, S) into each matmul as a strided shard, which torch
        2.11's DTensor cannot do and 2.13's plans slowly."""
        return self._constrain(L.rms_norm(x, gamma, self.cfg.norm_eps), GATHERED)

    @property
    def _mesh_constrain(self):
        """`_constrain` for the layers' ``constrain_fn`` on a mesh, else None."""
        return self._constrain if self.mesh is not None else None

    def _residual(self, x, out):
        """``x + out``, ``out`` first (on a mesh) redistributed to the
        residual stream's sequence sharding: Megatron-SP's reduce-scatter
        after a block, so that the backward hands the block its grad in
        its own layout (torch 2.11's DTensor cannot flatten a seq-sharded
        grad into the block's matmuls)."""
        return x + self._constrain(out, SEQ_SHARD)

    def _moe_groups(self) -> int:
        """Dispatch groups for MoE = number of data shards (GShard groups)."""
        if self.mesh is None:
            return 1
        sizes = sh.mesh_axes(self.mesh)
        g = 1
        for ax in self.pc.all_data_axes:
            g *= sizes.get(ax, 1)
        return g

    # -- specs / init / layouts ---------------------------------------------

    def specs(self) -> dict:
        return model_specs(self.cfg, self.segments)

    def param_shapes(self) -> dict:
        return {path: s.shape for path, s in L.tree_leaves(self.specs())}

    def logical(self) -> dict:
        """The spec tree's logical axes (stacked leaves lead with
        ``layers``)."""
        return L.logical_tree(self.specs())

    def _targets(self, path: str) -> tuple[list[str], bool]:
        """The ``named_parameters`` names a reference leaf path covers, in
        group order, and whether the leaf is stacked (scanned)."""
        head, _, rest = path.partition(".")
        if not head.startswith("seg"):
            return [path], False
        seg = self.segments[int(head[3:])]
        block, _, leaf = rest.partition(".")
        i = int(block[1:])
        return [f"layers.{seg.first_layer + g * len(seg.kinds) + i}.{leaf}"
                for g in range(seg.n_groups)], seg.scanned

    def to_tree(self, flat: Mapping[str, torch.Tensor]) -> dict:
        """A flat dict keyed like ``named_parameters`` (params, grads or
        moments) -> the reference's tree, scanned leaves stacked.  Every
        leaf is a fresh tensor (a snapshot the caller may keep)."""
        out = {}
        for path, _ in L.tree_leaves(self.specs()):
            names, scanned = self._targets(path)
            out[path] = torch.stack([flat[n] for n in names]) if scanned else flat[names[0]].clone()
        return _nest(out)

    def from_tree(self, tree: Mapping) -> dict:
        """The reference's tree -> a flat dict keyed like
        ``named_parameters`` (views of the stacked leaves)."""
        flat = {}
        for path, t in L.tree_leaves(tree):
            names, scanned = self._targets(path)
            flat.update(zip(names, t.unbind(0) if scanned else (t,)))
        return flat

    def train_params(self) -> dict:
        """The model's own parameters, keyed by name, set to require grad:
        the ``params`` of `train.steps.make_train_step`, updated in place
        (so the model serves what was trained)."""
        return {n: p.requires_grad_(True) for n, p in self.named_parameters()}

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

    def tree_shardings(self) -> dict:
        """The reference's tree (scanned leaves stacked) of ``(DeviceMesh,
        placements)``: where each leaf lies on the model's mesh, its
        stacked ``layers`` dim whole (`ckpt.manager.CheckpointManager.restore`'s
        ``shardings``)."""
        mesh = sh.compute_mesh(self.mesh)
        return _nest({path: (mesh, sh.placements_for(
            self.mesh, sh.spec_for(self.mesh, s.shape, s.logical, self.rules)))
            for path, s in L.tree_leaves(self.specs())})

    def _assign(self, path: str, value: torch.Tensor) -> None:
        """Copy a leaf of the reference's tree into its params.  On a mesh
        a whole value (every rank holds the same one: `init` draws it in
        full, as the unsharded init does) is cut to each rank's shard, and
        a DTensor value is laid out as the param is."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        names, scanned = self._targets(path)
        for g, name in enumerate(names):
            p = self.get_parameter(name)
            v = value[g] if scanned else value
            if isinstance(p, DTensor):
                v = (v.redistribute(p.device_mesh, p.placements) if isinstance(v, DTensor)
                     else distribute_tensor(v, p.device_mesh, p.placements, src_data_rank=None))
            p.copy_(v)

    def _view(self, params: "Mapping[str, torch.Tensor] | None" = None) -> dict:
        """The params the forward reads: the model's own, or ``params``
        (every name of ``named_parameters``, e.g. bf16 casts of them)."""
        if params is None:
            return dict(embed=self._embed_view(self.embed), layers=list(self.layers),
                        final_norm=self.final_norm, encoder=self.encoder,
                        patch_proj=self.patch_proj)
        tree = _nest(params)
        return dict(embed=self._embed_view(tree["embed"]),
                    layers=[tree["layers"][str(i)] for i in range(len(self.kinds))],
                    final_norm=tree["final_norm"], encoder=tree.get("encoder"),
                    patch_proj=tree.get("patch_proj"))

    def _embed_view(self, emb):
        """The embedding leaves; on a mesh each read through a redistribute
        to its own placement, so that a tied table's two grads (the
        embedding's and the unembedding's, in different layouts) each come
        back in the param's layout before autograd sums them (torch 2.11's
        DTensor cannot sum them as they are)."""
        if self.mesh is None:
            return emb
        specs = L.embed_specs(self.cfg)
        return {k: self._constrain(emb[k], s.logical) for k, s in specs.items()}

    # -- inputs and the encoder ---------------------------------------------

    def _required(self, batch: dict, name: str, rows: int) -> torch.Tensor:
        if name not in batch:
            raise ValueError(
                f"{self.cfg.name} reads batch[{name!r}] (B, {rows}, {self.cfg.d_model}): "
                f"precomputed {'encoder frame' if name == 'frames' else 'image patch'} "
                f"embeddings, and the batch has none")
        return batch[name]

    def _inputs(self, P: dict, batch: dict):
        """Token embeddings with the projected patches prepended, and the
        encoder output (or None)."""
        cfg, cd = self.cfg, self.compute_dtype
        x = L.embed(P["embed"], batch["tokens"], cfg).to(cd)
        enc_out = None
        if cfg.is_encoder_decoder:
            enc_out = self._encoder(P["encoder"], self._required(batch, "frames", cfg.enc_seq))
        if cfg.n_patches:
            patches = self._required(batch, "patches", cfg.n_patches).to(cd)
            x = torch.cat([patches @ P["patch_proj"].to(cd), x], dim=1)
        return x, enc_out

    def _encoder(self, enc, frames: torch.Tensor) -> torch.Tensor:
        """Whisper-style bidirectional encoder over precomputed frame
        embeddings: learned positions plus RoPE at ``arange(enc_seq)``."""
        cfg, cd = self.cfg, self.compute_dtype
        x = frames.to(cd) + enc["pos_embed"].to(cd)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        n_rep = cfg.n_heads // cfg.n_kv_heads
        for i in range(cfg.n_enc_layers):
            p = enc[f"b{i}"]
            h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
            q, k, v = L._project_qkv(p["attn"], h, cfg, positions, cfg.rope_theta)
            attend = functools.partial(L.chunked_attention, causal=False,
                                       q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)
            out = L._attend(attend, q, L._repeat_kv(k, n_rep), L._repeat_kv(v, n_rep),
                            self._mesh_constrain)
            x = x + L.reshape(out, b, s, -1).to(x.dtype) @ p["attn"]["wo"].to(x.dtype)
            h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
            x = x + L.mlp(p["mlp"], h, cfg)
        return L.rms_norm(x, enc["norm"], cfg.norm_eps)

    # -- block forward (train/prefill) --------------------------------------

    def _block_train(self, i: int, p, x, kind: str, enc_out=None):
        """Block ``i`` over the whole sequence -> (x, prefill cache, MoE aux
        loss or None).  The cache is ``(k, v)`` un-repeated for attention,
        ``(c, k_rope)`` for ``mla``, ``(k, v, xk, xv)`` for ``xattn``,
        ``dict(conv, state)`` for the
        recurrent kinds.  Spans ``block.attn`` (the mixer, cross-attention
        included) and ``block.ffn``, each with its norm and residual add."""
        cfg = self.cfg
        with trace.span("block.attn", self._span_attrs[i]):
            h = self._norm(x, p["norm1"])
            if kind in ("attn", "local", "xattn"):
                out, cache = L.attention_train(
                    p["attn"], h, cfg, "attn" if kind == "xattn" else kind, cfg.rope_theta,
                    q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
                    constrain_fn=self._mesh_constrain)
            elif kind == "mla":
                out, cache = L.mla_train(p["attn"], h, cfg, q_chunk=self.q_chunk,
                                         kv_chunk=self.kv_chunk)
            elif kind == "ssm":
                out, cache = S.mamba2_forward(p["ssm"], h, cfg)
                return self._residual(x, out), cache, None
            elif kind == "rglru":
                out, cache = S.rglru_forward(p["rglru"], h, cfg)
            else:
                raise ValueError(kind)
            x = self._residual(x, out)
            if kind == "xattn":
                h = self._norm(x, p["norm_x"])
                xkv = L.encode_kv(p["xattn"], enc_out, cfg)
                x = self._residual(x, L.cross_attention(p["xattn"], h, xkv, cfg,
                                                        constrain_fn=self._mesh_constrain))
                cache = (*cache, *xkv)
        with trace.span("block.ffn", self._span_attrs[i]):
            h = self._norm(x, p["norm2"])
            aux = None
            if "moe" in p:
                ff, aux = L.moe_ffn(p["moe"], h, cfg, n_groups=self._moe_groups(),
                                    constrain_fn=self._mesh_constrain)
            else:
                ff = L.mlp(p["mlp"], h, cfg)
            return self._constrain(self._residual(x, ff), SEQ_SHARD), cache, aux

    def _group_train(self, group, x, enc_out):
        """The blocks ``(layer, params, kind)`` of one scan group -> (x,
        summed aux loss)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, p, kind in group:
            x, _, a = self._block_train(i, p, x, kind, enc_out)
            if a is not None:
                aux = aux + a
        return x, aux

    # -- public forwards ----------------------------------------------------

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence (teacher-forced) forward -> (logits, moe_aux_loss);
        the aux loss sums over the MoE layers (0 without any)."""
        x, aux = self.backbone(batch)
        return L.unembed(self.embed, x, self.cfg), aux

    def backbone(self, batch: dict, params=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Everything up to (but excluding) the unembedding -> (x, aux),
        the patch positions stripped.  ``params`` (see `_view`) replaces
        the model's own.  Under autograd each scan group of a scanned
        segment runs under `torch.utils.checkpoint` as ``pc.remat`` says
        (the reference's ``jax.checkpoint`` of its scan body): ``full``
        saves nothing, ``block`` saves the plain matmuls' outputs, ``none``
        keeps everything."""
        cfg = self.cfg
        P = self._view(params)
        x, enc_out = self._inputs(P, batch)
        x = self._constrain(x, SEQ_SHARD)
        remat = self.pc.remat if torch.is_grad_enabled() else "none"
        kw = dict(use_reentrant=False)
        if remat == "block":
            kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                 _save_dots)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for seg in self.segments:
            n = len(seg.kinds)
            for g in range(seg.n_groups):
                first = seg.first_layer + g * n
                group = [(first + i, P["layers"][first + i], kind)
                         for i, kind in enumerate(seg.kinds)]
                run = functools.partial(self._group_train, group)
                if seg.scanned and remat != "none":
                    x, aux = ckpt.checkpoint(run, x, enc_out, **kw)
                else:
                    x, aux = run(x, enc_out)
                aux_total = aux_total + aux
        x = self._norm(x, P["final_norm"])
        if cfg.n_patches:
            x = x[:, cfg.n_patches:, :]
        return x, aux_total

    # -- loss ----------------------------------------------------------------

    def loss_fn(self, batch: dict, aux_weight: float = 0.01, ce_chunk: int = 512,
                params=None):
        """Chunked cross-entropy -> (loss, dict(loss, aux, ntokens)).

        The (B, S, V) fp32 logits are never materialized: each sequence
        chunk is unembedded and reduced under `torch.utils.checkpoint` (the
        reference checkpoints its scanned ``chunk_nll``), so the backward
        recomputes one chunk's logits at a time.  ``batch`` holds
        ``tokens``, ``labels`` and optionally ``mask`` (ones by default);
        ``params`` as in `backbone`."""
        cfg = self.cfg
        P = self._view(params)
        x, aux = self.backbone(batch, params)
        labels = batch["labels"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)

        def chunk_nll(xq, lq, mq):
            logits = L.unembed(P["embed"], xq, cfg).float()
            logz = torch.logsumexp(logits, dim=-1)
            # on a mesh a vocab-sharded gather is a masked partial sum,
            # reduced here: DTensor keeps its mask for the gather's own shape
            gold = self._constrain(logits.gather(-1, lq[..., None]), ("batch", None, None))
            return torch.sum((logz - gold[..., 0]) * mq)

        s = x.shape[1]
        c = L._pick_chunk(s, ce_chunk)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, c):
            args = (x[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c])
            if torch.is_grad_enabled():
                total = total + ckpt.checkpoint(chunk_nll, *args, use_reentrant=False)
            else:
                total = total + chunk_nll(*args)
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = total / denom + aux_weight * aux
        return loss, dict(loss=loss, aux=aux, ntokens=denom)

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
        hd = cfg.resolved_head_dim
        if kind == "mla":
            return dict(c=zeros(batch, max_seq, cfg.kv_lora_rank),
                        kr=zeros(batch, max_seq, cfg.qk_rope_head_dim))
        if kind in ("attn", "local", "xattn"):
            shp = (batch, self.cache_len(kind, max_seq), cfg.n_kv_heads, hd)
            c = dict(k=zeros(*shp), v=zeros(*shp))
            if kind == "xattn":
                xs = (batch, cfg.enc_seq, cfg.n_kv_heads, hd)
                c.update(xk=zeros(*xs), xv=zeros(*xs))
            return c
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

    def cache_logical(self, kind: str) -> dict:
        """Logical axes of `cache_shape_for`'s entries (the reference's
        names): alignment pads and rotates the ``kv_seq`` axis only, so the
        cross-attention keys and values pass through it."""
        if kind == "mla":
            return dict(c=("batch", "kv_seq", None), kr=("batch", "kv_seq", None))
        if kind in ("attn", "local", "xattn"):
            kv = ("batch", "kv_seq", "kv_heads", None)
            c = dict(k=kv, v=kv)
            if kind == "xattn":
                c.update(xk=("batch", None, "kv_heads", None), xv=("batch", None, "kv_heads", None))
            return c
        if kind == "ssm":
            return dict(conv=("batch", None, "ssm_inner"), state=("batch", "ssm_heads", None, None))
        if kind == "rglru":
            return dict(conv=("batch", None, "lru"), state=("batch", "lru"))
        raise ValueError(kind)

    def init_cache(self, batch: int, max_seq: int) -> list[dict]:
        return [self.cache_shape_for(k, batch, max_seq) for k in self.kinds]

    def cache_logical_tree(self) -> list[dict]:
        """The reference's cache layout of logical axes: one ``{b{i}: ...}``
        per segment, a scanned segment's leaves leading with ``layers``
        (the recurrent kinds' ``(conv, state)`` pair as the port's
        ``dict(conv, state)``)."""
        out = []
        for seg in self.segments:
            seg_l = {f"b{i}": self.cache_logical(k) for i, k in enumerate(seg.kinds)}
            if seg.scanned:
                seg_l = {b: {n: ("layers", *lg) for n, lg in c.items()}
                         for b, c in seg_l.items()}
            out.append(seg_l)
        return out

    def _block_decode(self, i: int, p, x, kind, cache, pos: int):
        """Block ``i`` for one token; spans as `_block_train`'s."""
        cfg = self.cfg
        with trace.span("block.attn", self._span_attrs[i]):
            h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
            if kind in ("attn", "local", "xattn"):
                out, cache = L.attention_decode(p["attn"], h, cfg,
                                                "attn" if kind == "xattn" else kind,
                                                cfg.rope_theta, cache, pos, self._mesh_constrain)
            elif kind == "mla":
                out, cache = L.mla_decode(p["attn"], h, cfg, cache, pos)
            elif kind == "ssm":
                out, cache = S.mamba2_decode(p["ssm"], h, cfg, cache)
                return self._constrain(x + out, SEQ_SHARD), cache
            elif kind == "rglru":
                out, cache = S.rglru_decode(p["rglru"], h, cfg, cache)
            else:
                raise ValueError(kind)
            x = x + out
            if kind == "xattn":
                h = L.rms_norm(x, p["norm_x"], cfg.norm_eps)
                x = x + L.cross_attention(p["xattn"], h, (cache["xk"], cache["xv"]), cfg,
                                          constrain_fn=self._mesh_constrain)
        with trace.span("block.ffn", self._span_attrs[i]):
            h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
            if "moe" in p:
                ff, _ = L.moe_ffn(p["moe"], h, cfg, n_groups=self._moe_groups(),
                                  constrain_fn=self._mesh_constrain)
            else:
                ff = L.mlp(p["mlp"], h, cfg)
            return self._constrain(x + ff, SEQ_SHARD), cache

    def decode_step(self, caches: list[dict], token: torch.Tensor, pos: int):
        """One decode step.  token: (B,) ints on the model's device; pos: the
        host int position, one for the whole batch (after the patch prefix,
        if any).  The caches are updated in place and returned.  Span
        ``model.decode_step`` over ``block.*`` and ``model.unembed``."""
        with trace.span("model.decode_step"):
            x = L.embed(self.embed, token[:, None], self.cfg).to(self.compute_dtype)
            x = self._constrain(x, SEQ_SHARD)
            for i, (p, kind) in enumerate(zip(self.layers, self.kinds)):
                x, caches[i] = self._block_decode(i, p, x, kind, caches[i], pos)
            with trace.span("model.unembed"):
                x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
                logits = L.unembed(self.embed, x, self.cfg)
            return logits[:, 0, :], caches

    def prefill(self, batch: dict):
        """Prompt pass: returns (last-position logits, per-layer caches).
        The encoder and the patch prefix run first; local layers keep only
        their last ``window`` keys; ``xattn`` layers keep the encoder's
        cross keys and values; recurrent layers keep their conv inputs and
        final fp32 state; ``mla`` layers keep the normed latent and the
        rotary key.  On a card, a model with layers of the decode kernel's
        kinds (`KERNEL_KINDS`) starts building it first
        (`layers.prefetch_decode_kernel`).
        Span ``model.prefill`` over ``block.*`` and ``model.unembed``."""
        cfg, cd = self.cfg, self.compute_dtype
        with trace.span("model.prefill"):
            x, enc_out = self._inputs(self._view(), batch)
            x = self._constrain(x, SEQ_SHARD)
            if any(k in KERNEL_KINDS for k in self.kinds):
                L.prefetch_decode_kernel(x, self._mesh_constrain)
            caches = []
            for i, (p, kind) in enumerate(zip(self.layers, self.kinds)):
                x, cache, _ = self._block_train(i, p, x, kind, enc_out)
                if kind in RECURRENT_KINDS:
                    caches.append(cache)
                    continue
                if kind == "mla":
                    caches.append(dict(c=cache[0].to(cd), kr=cache[1].to(cd)))
                    continue
                k, v, *xkv = cache
                if kind == "local" and cfg.window and cfg.window < x.shape[1]:
                    k = k[:, -cfg.window:]
                    v = v[:, -cfg.window:]
                c = dict(k=k.to(cd), v=v.to(cd))
                if xkv:
                    c.update(xk=xkv[0].to(cd), xv=xkv[1].to(cd))
                caches.append(c)
            with trace.span("model.unembed"):
                x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
                logits = L.unembed(self.embed, x[:, -1:, :], cfg)
            return logits[:, 0, :], caches
