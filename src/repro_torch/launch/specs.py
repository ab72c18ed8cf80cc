"""Meta DTensor stand-ins + placements for every (arch x shape) cell.

The counterpart of the reference's ``launch/specs.py``: where it builds
``ShapeDtypeStruct`` trees with ``NamedSharding``s, a `CellSpec` builds
DTensors on ``meta`` (shapes, dtypes and placements, nothing allocated)
over a `DeviceMesh` of the fake process group (`launch.mesh`), placed by
the ported logical-axis rules (`parallel.sharding`).  The dtypes are the
reference's: fp32 params and optimizer state for train, bf16 params for
prefill and decode (the port keeps `models.model.FP32_PARAMS` in fp32 in
a bf16 model, a few vectors), int32 tokens and labels, an fp32 mask, bf16
frames and patches.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs import get_config
from ..models.config import SHAPES, ModelConfig, ParallelConfig
from ..models import layers as L
from ..models.model import Model
from ..optim.adamw import AdamWConfig, adamw_init, constant_schedule
from ..parallel import sharding as sh
from ..train.steps import make_train_step


def batch_logical(cfg: ModelConfig, train: bool) -> dict:
    out = dict(tokens=("batch", None))
    if train:
        out["labels"] = ("batch", None)
        out["mask"] = ("batch", None)
    if cfg.is_encoder_decoder:
        out["frames"] = ("batch", None, None)
    if cfg.n_patches:
        out["patches"] = ("batch", None, None)
    return out


def _batch_shapes(cfg: ModelConfig, b: int, s: int, train: bool) -> dict:
    """name -> (shape, dtype) of a train / prefill batch."""
    out = dict(tokens=((b, s), torch.int32))
    if train:
        out["labels"] = ((b, s), torch.int32)
        out["mask"] = ((b, s), torch.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = ((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.n_patches:
        out["patches"] = ((b, cfg.n_patches, cfg.d_model), torch.bfloat16)
    return out


class CellSpec:
    """Everything needed to trace one (arch x shape x mesh) cell.

    The model is built on ``meta`` with its params as DTensors on ``mesh``
    -- fp32 for a train shape, bf16 for prefill and decode -- so
    `param_sds` is the model's own parameters.
    """

    def __init__(self, arch: str, shape_name: str, mesh, pc: ParallelConfig | None = None,
                 cfg: ModelConfig | None = None, q_chunk: int = 1024, kv_chunk: int = 1024,
                 remat: str = "full", grad_accum: int = 1,
                 cast_bf16: bool = False, shard_grads: bool = False,
                 rules_patch: dict | None = None):
        from .mesh import parallel_config_for

        self.arch = arch
        self.shape = SHAPES[shape_name]
        self.cfg = cfg or get_config(arch)
        self.mesh = mesh
        self.device = torch.device("meta")
        self.pc = pc or parallel_config_for(mesh)
        if remat != self.pc.remat:
            self.pc = dataclasses.replace(self.pc, remat=remat)
        self.rules = sh.rules_for_model(self.cfg, self.pc, mesh)
        if rules_patch:
            self.rules.update(rules_patch)
        train = self.shape.kind == "train"
        self.model = Model(self.cfg, self.pc, mesh=mesh, rules=self.rules,
                           q_chunk=q_chunk, kv_chunk=kv_chunk, device=self.device,
                           param_dtype=torch.float32 if train else torch.bfloat16)
        self.grad_accum = grad_accum
        self.cast_bf16 = cast_bf16
        self.shard_grads = shard_grads

    def _sds(self, shape, logical, dtype):
        spec = sh.spec_for(self.mesh, shape, logical, self.rules)
        return sh.sharded_zeros(self.mesh, shape, spec, dtype, self.device)

    def _placements(self, shape, logical) -> tuple:
        return sh.placements_for(self.mesh, sh.spec_for(self.mesh, shape, logical, self.rules))

    # -- parameter / optimizer stand-ins + placements -------------------------

    def param_sds(self) -> dict:
        """The model's parameters, keyed like ``named_parameters``."""
        return dict(self.model.named_parameters())

    def param_specs(self) -> dict:
        """The reference's param tree path -> its spec."""
        logical = dict(L.tree_leaves(self.model.logical()))
        return {path: sh.spec_for(self.mesh, shp, logical[path], self.rules)
                for path, shp in self.model.param_shapes().items()}

    def param_shardings(self) -> dict:
        """Placements keyed like ``named_parameters`` (a scanned leaf's
        layers share its spec, the ``layers`` dim dropped)."""
        out = {}
        for path, spec in self.param_specs().items():
            names, scanned = self.model._targets(path)
            if scanned:
                assert spec[:1] in ((), (None,)), (path, spec)
                spec = spec[1:]
            for n in names:
                out[n] = sh.placements_for(self.mesh, spec)
        return out

    def opt_sds(self, opt_cfg: AdamWConfig) -> dict:
        """``adamw_init`` of the params: moments placed like them, the step
        a replicated int32 scalar."""
        state = adamw_init(self.param_sds(), opt_cfg)
        state["step"] = self._sds((), (), torch.int32)
        return state

    def opt_shardings(self, opt_cfg: AdamWConfig) -> dict:
        ps = self.param_shardings()
        moments = dict(step=sh.placements_for(self.mesh, ()), m=ps, v=ps)
        if opt_cfg.compression == "int8_ef":
            moments["ef"] = ps
        return moments

    # -- inputs ---------------------------------------------------------------

    def _batch_logical(self) -> dict:
        s = self.shape
        if s.kind in ("train", "prefill"):
            return batch_logical(self.cfg, s.kind == "train")
        return dict(token=("batch",))

    def input_sds(self) -> dict:
        """The step's batch; decode: one token per sequence and ``pos``, the
        host int the port's `decode_step` takes (the last cache slot)."""
        s = self.shape
        if s.kind == "decode":
            return dict(token=self._sds((s.global_batch,), ("batch",), torch.int32),
                        pos=s.seq_len - 1)
        shapes = _batch_shapes(self.cfg, s.global_batch, s.seq_len, s.kind == "train")
        lg = self._batch_logical()
        return {k: self._sds(shp, lg[k], dt) for k, (shp, dt) in shapes.items()}

    def batch_shardings(self) -> dict:
        inp = self.input_sds()
        return {k: self._placements(inp[k].shape, lg) for k, lg in self._batch_logical().items()}

    def cache_sds(self) -> list[dict]:
        """One ``init_cache`` entry per layer, each leaf placed by its
        logical axes."""
        s, m = self.shape, self.model
        out = []
        for kind in m.kinds:
            lg = m.cache_logical(kind)
            out.append({n: self._sds(t.shape, lg[n], t.dtype)
                        for n, t in m.cache_shape_for(kind, s.global_batch, s.seq_len).items()})
        return out

    def cache_shardings(self) -> list[dict]:
        return [{n: self._placements(t.shape, self.model.cache_logical(kind)[n])
                 for n, t in c.items()}
                for kind, c in zip(self.model.kinds, self.cache_sds())]

    # -- the step function to trace -------------------------------------------

    def step_fn_and_args(self, opt_cfg: AdamWConfig | None = None):
        """Returns (fn, args, placements, donated argument indices)."""
        s = self.shape
        m = self.model
        if s.kind == "train":
            opt_cfg = opt_cfg or AdamWConfig()
            step = make_train_step(
                m, constant_schedule(1e-4), opt_cfg,
                grad_accum=self.grad_accum,
                cast_bf16=self.cast_bf16,
                grad_shardings=self.param_shardings() if self.shard_grads else None,
            )
            args = (m.train_params(), self.opt_sds(opt_cfg), self.input_sds())
            shards = (self.param_shardings(), self.opt_shardings(opt_cfg),
                      self.batch_shardings())
            return step, args, shards, (0, 1)  # params + opt state, updated in place
        if s.kind == "prefill":
            fn = lambda params, batch: m.prefill(batch)
            return fn, (self.param_sds(), self.input_sds()), (
                self.param_shardings(), self.batch_shardings()), ()
        # decode: serve_step
        fn = lambda params, caches, token, pos: m.decode_step(caches, token, pos)
        inp = self.input_sds()
        args = (self.param_sds(), self.cache_sds(), inp["token"], inp["pos"])
        shards = (self.param_shardings(), self.cache_shardings(),
                  self.batch_shardings()["token"], ())
        return fn, args, shards, (1,)  # the KV caches, updated in place

