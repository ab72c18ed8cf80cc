"""The port's LM (``repro_torch.models``) against the reference's: the
dense family, the MoE family, the recurrent families (Mamba-2 and
RG-LRU blocks), the encoder-decoder (whisper-tiny: the encoder and the
cross-attention ``xattn`` blocks) and the VLM patch prefix (internvl2-2b).

Params come from the reference's ``Model.init`` and cross over as numpy
through ``params_from_reference``; token inputs are made from a seed with
numpy.  Compute is fp32 in both packages.  Parity tolerances: logits
within ``atol=2e-4`` for the dense family (their scale is 1-5 here; the
measured gap is 1e-6-3e-5, summation order) and ``1e-4`` for the new
kinds, caches and recurrent states within ``rtol=1e-4`` (dense) and
``1e-5`` (new kinds) of their own scale, the MoE aux loss within 1e-6
relative.  The encoder-decoder and VLM archs are held as the new kinds,
their frames and patches drawn from a seed with numpy.  The port-alone
checks keep the reference's own tolerances (2e-3 prefill, 5e-3 decode;
``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import ParallelConfig as RParallelConfig
from repro.models.model import Model as RModel
from repro.serve.engine import align_prefill_caches as r_align
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models.config import ParallelConfig
from repro_torch.models.interop import (caches_from_reference, caches_to_reference,
                                        params_from_reference)
from repro_torch.models.model import FP32_PARAMS, Model, build_segments, keeps_fp32, model_specs
from repro_torch.serve.engine import align_prefill_caches

DENSE = ("minicpm-2b", "qwen1.5-4b", "gemma3-27b", "deepseek-coder-33b")
MOE = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")
RECURRENT = ("mamba2-780m", "recurrentgemma-9b")
ENC_DEC_VLM = ("whisper-tiny", "internvl2-2b")
ARCHS = DENSE + MOE + RECURRENT + ENC_DEC_VLM
LOGIT_ATOL = 2e-4
#: the new kinds' tolerances: logits (absolute), caches (share of their scale)
NEW_LOGIT_ATOL, NEW_CACHE_RTOL = 1e-4, 1e-5


def lengths(arch):
    """(S, P): mamba2's smoke SSD chunk is 8, which must divide a length
    above it; prompt 20 > the smoke window 16 elsewhere."""
    return (32, 24) if arch == "mamba2-780m" else (28, 20)


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def extras(cfg, b, seed=1) -> dict:
    """The inputs a config reads besides the tokens, as numpy: encoder
    frames (whisper) or image patches (internvl2)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        out["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def jbatch(toks, extra) -> dict:
    return dict(tokens=jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()})


def tbatch(tt, extra) -> dict:
    return dict(tokens=tt, **{k: torch.as_tensor(v) for k, v in extra.items()})


def ref_model(arch, q_chunk=8):
    from repro.configs import smoke_config as r_smoke

    m = RModel(r_smoke(arch), RParallelConfig(scan_layers=True), compute_dtype=jnp.float32,
               q_chunk=q_chunk, kv_chunk=q_chunk)
    return m, m.init(jax.random.PRNGKey(0))


def port_model(cfg, params=None, q_chunk=8, seed=0):
    m = Model(cfg, ParallelConfig(scan_layers=True), compute_dtype=torch.float32,
              q_chunk=q_chunk, kv_chunk=q_chunk, device="cpu")
    if params is None:
        return m.init(torch.Generator().manual_seed(seed))
    return params_from_reference(m, jax.tree.map(np.asarray, params))


def same_caches(got, want, rel=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in w:
            assert g[name].dtype == w[name].dtype, name
            scale = float(w[name].abs().max())
            torch.testing.assert_close(g[name], w[name], rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_caches_and_decode_equal_the_reference(arch):
    """Teacher-forced logits and aux loss, prefill logits and caches, the
    aligned caches and 8 decode steps.  Prompt 20 > the smoke window 16,
    so gemma3's and recurrentgemma's ring caches are cut to the window
    and rotated by 4; recurrent states and whisper's cross keys and
    values (``xk``/``xv``) pass alignment unchanged; internvl2's 8 patch
    positions lead every cache and offset the decode positions."""
    rm, params = ref_model(arch)
    pm = port_model(smoke_config(arch), params)
    B, (S, P) = 2, lengths(arch)
    atol, rel = (LOGIT_ATOL, 1e-4) if arch in DENSE else (NEW_LOGIT_ATOL, NEW_CACHE_RTOL)
    toks = tokens(pm.cfg, B, S)
    extra, npch = extras(pm.cfg, B), pm.cfg.n_patches

    r_full, r_aux = jax.jit(rm.forward)(params, jbatch(toks, extra))
    r_last, r_caches = jax.jit(rm.prefill)(params, jbatch(toks[:, :P], extra))
    r_aligned = r_align(rm, r_caches, npch + P, npch + S, batch=B)
    decode = jax.jit(rm.decode_step)
    r_steps, cur = [], r_aligned
    for t in range(P, S):
        lg, cur = decode(params, cur, jnp.asarray(toks[:, t]), jnp.int32(npch + t))
        r_steps.append(np.asarray(lg))

    tt = torch.as_tensor(toks, dtype=torch.int64)
    with torch.no_grad():
        full, aux = pm.forward(tbatch(tt, extra))
        np.testing.assert_allclose(full.numpy(), np.asarray(r_full), atol=atol, rtol=0)
        if arch in MOE:
            assert float(aux) > 0
            np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-6)
        else:
            assert float(aux) == 0.0 == float(r_aux)
        last, caches = pm.prefill(tbatch(tt[:, :P], extra))
        np.testing.assert_allclose(last.numpy(), np.asarray(r_last), atol=atol, rtol=0)
        same_caches(caches, caches_from_reference(pm, jax.tree.map(np.asarray, r_caches)), rel)
        caches = align_prefill_caches(pm, caches, npch + P, npch + S, batch=B)
        same_caches(caches, caches_from_reference(pm, jax.tree.map(np.asarray, r_aligned)), rel)
        assert all(c["state"].dtype == torch.float32 for c in caches if "state" in c)
        assert all(c["xk"].shape[1] == pm.cfg.enc_seq for c in caches if "xk" in c)
        for i, t in enumerate(range(P, S)):
            lg, caches = pm.decode_step(caches, tt[:, t], npch + t)
            np.testing.assert_allclose(lg.numpy(), r_steps[i], atol=atol, rtol=0)


def decode_against_forward(m, B, S, P):
    tt = torch.as_tensor(tokens(m.cfg, B, S), dtype=torch.int64)
    extra, npch = extras(m.cfg, B), m.cfg.n_patches
    with torch.no_grad():
        full, _ = m.forward(tbatch(tt, extra))
        last, caches = m.prefill(tbatch(tt[:, :P], extra))
        caches = align_prefill_caches(m, caches, npch + P, npch + S, batch=B)
        prefill_err = float((last - full[:, P - 1]).abs().max())
        worst = 0.0
        for t in range(P, S):
            lg, caches = m.decode_step(caches, tt[:, t], npch + t)
            worst = max(worst, float((lg - full[:, t]).abs().max()))
    return prefill_err, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Serving correctness in the port alone (``tests/test_models.py:53``):
    prefill + decode logits == the teacher-forced forward (the MoE smoke
    configs are dropless, capacity factor 8)."""
    prefill_err, worst = decode_against_forward(port_model(smoke_config(arch)), 2, 24, 16)
    assert prefill_err < 2e-3, (arch, prefill_err)
    assert worst < 5e-3, (arch, worst)


@pytest.mark.parametrize("plen", [8, 16, 20, 24])
def test_ring_cache_alignment_property(plen):
    """Local-attention ring cache: decode must match forward for prompt
    lengths below, at, and above the window (``tests/test_models.py:154``)."""
    m = port_model(smoke_config("gemma3-27b"))  # window=16
    assert m.cfg.window == 16
    prefill_err, worst = decode_against_forward(m, 2, 28, plen)
    assert prefill_err < 2e-3 and worst < 5e-3, (plen, prefill_err, worst)


def test_vocab_padding_semantics():
    """Padded logit rows never win argmax (``tests/test_models.py:117``)."""
    cfg = dataclasses.replace(smoke_config("minicpm-2b"), vocab_pad_multiple=128)
    assert cfg.padded_vocab == 512
    cfg = dataclasses.replace(cfg, vocab_size=500)
    assert cfg.padded_vocab == 512
    m = Model(cfg, ParallelConfig(), device="cpu").init(torch.Generator().manual_seed(0))
    tt = torch.as_tensor(tokens(cfg, 2, 8), dtype=torch.int64)
    with torch.no_grad():
        logits, _ = m.forward(dict(tokens=tt))
        last, _ = m.prefill(dict(tokens=tt))
    assert logits.shape[-1] == 512
    assert float(logits[..., 500:].max()) <= -1e29
    assert (logits.argmax(-1) < 500).all() and (last.argmax(-1) < 500).all()


@pytest.mark.parametrize("arch", DENSE)
def test_init_shapes_and_per_leaf_std_follow_the_reference(arch):
    """Leaf paths and shapes equal the reference's; each drawn leaf's std
    is ``scale / sqrt(shape[0])`` -- for a scanned (stacked) leaf the layer
    count, not the input width (the reference's fan-in quirk)."""
    from repro.configs import smoke_config as r_smoke
    from repro.models.layers import is_spec

    # 13 layers: every pattern scans >= 2 groups; gemma3 (6) keeps one unscanned
    cfg = dataclasses.replace(smoke_config(arch), n_layers=13)
    r_specs = RModel(dataclasses.replace(r_smoke(arch), n_layers=13), RParallelConfig()).specs()
    r_flat = {
        ".".join(str(k.key) for k in path): s
        for path, s in jax.tree_util.tree_flatten_with_path(r_specs, is_leaf=is_spec)[0]
    }
    m = Model(cfg, ParallelConfig(), device="cpu")
    assert m.param_shapes() == {k: s.shape for k, s in r_flat.items()}
    assert any(seg.scanned for seg in m.segments)

    m.init(torch.Generator().manual_seed(0))
    n_checked = 0
    for seg_i, seg in enumerate(m.segments):
        for i in range(len(seg.kinds)):
            p = m.layers[seg.first_layer + i]
            for leaf in ("attn.wq", "attn.wo", "mlp.w_gate", "mlp.w_down"):
                spec = r_flat[f"seg{seg_i}.b{i}.{leaf}"]
                want = spec.scale / np.sqrt(spec.shape[0])
                a, b = leaf.split(".")
                vals = torch.stack([m.layers[seg.first_layer + g * len(seg.kinds) + i][a][b]
                                    for g in range(seg.n_groups)])
                assert abs(float(vals.std()) / want - 1) < 0.05, (leaf, float(vals.std()), want)
                n_checked += 1
            assert float(p["norm1"].abs().max()) == 0.0  # zeros init
    assert n_checked
    tok = m.embed["tok"]
    assert abs(float(tok.std()) * np.sqrt(cfg.padded_vocab) - 1) < 0.05
    full = get_config("minicpm-2b")  # published: 40 scanned layers -> std 1/sqrt(40)
    spec = model_specs(full, build_segments(full))["seg0"]["b0"]["attn"]["wq"]
    assert spec.shape == (40, 2304, 2304) and abs(spec.std() - 1 / np.sqrt(40)) < 1e-12


@pytest.mark.parametrize("fault", ["missing", "extra", "misshaped"])
def test_params_from_reference_rejects_a_bad_tree(fault):
    rm, params = ref_model("minicpm-2b")
    tree = jax.tree.map(np.asarray, params)
    if fault == "missing":
        del tree["seg0"]["b0"]["attn"]["wq"]
    elif fault == "extra":
        tree["seg0"]["b0"]["attn"]["bq"] = np.zeros((64,), np.float32)
    else:
        tree["final_norm"] = np.zeros((65,), np.float32)
    m = Model(smoke_config("minicpm-2b"), ParallelConfig(), device="cpu")
    with pytest.raises((KeyError, ValueError), match="wq|bq|final_norm"):
        params_from_reference(m, tree)
    # nothing was written before the check failed
    assert all(float(p.abs().max()) == 0.0 for p in m.parameters())


@pytest.mark.parametrize("arch", RECURRENT + MOE[:1] + ENC_DEC_VLM)
def test_port_caches_continue_the_reference_decode(arch):
    """The port's aligned prefill caches, carried back by
    ``caches_to_reference`` (whisper's ``xk``/``xv`` included), let the
    reference's ``decode_step`` go on where the port's would: the same
    logits for 4 steps."""
    rm, params = ref_model(arch)
    pm = port_model(smoke_config(arch), params)
    B, (S, P) = 2, lengths(arch)
    toks = tokens(pm.cfg, B, S)
    extra, npch = extras(pm.cfg, B), pm.cfg.n_patches
    tt = torch.as_tensor(toks, dtype=torch.int64)
    with torch.no_grad():
        _, caches = pm.prefill(tbatch(tt[:, :P], extra))
        caches = align_prefill_caches(pm, caches, npch + P, npch + S, batch=B)
        r_cur = jax.tree.map(jnp.asarray, caches_to_reference(pm, caches))
        decode = jax.jit(rm.decode_step)
        for t in range(P, P + 4):
            lg, caches = pm.decode_step(caches, tt[:, t], npch + t)
            r_lg, r_cur = decode(params, r_cur, jnp.asarray(toks[:, t]), jnp.int32(npch + t))
            np.testing.assert_allclose(lg.numpy(), np.asarray(r_lg), atol=NEW_LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ENC_DEC_VLM)
def test_encoder_and_patch_leaves_follow_the_reference(arch):
    """The reference's tree with ``encoder`` (unscanned ``b{i}``, ``norm``,
    ``pos_embed`` of std 0.02 / sqrt(enc_seq)) or ``patch_proj``; the
    aligned caches hold the encoder's frames in ``xk``/``xv`` (no
    ``kv_seq`` axis) and the patch prefix ahead of the prompt."""
    from repro.configs import smoke_config as r_smoke

    cfg = dataclasses.replace(smoke_config(arch), enc_seq=1500 if smoke_config(arch).enc_seq else 0)
    r_shapes = RModel(dataclasses.replace(r_smoke(arch), enc_seq=cfg.enc_seq),
                      RParallelConfig()).param_shapes()
    r_flat = {".".join(str(k.key) for k in path): shp
              for path, shp in jax.tree_util.tree_flatten_with_path(
                  r_shapes, is_leaf=lambda t: isinstance(t, tuple))[0]}
    m = Model(cfg, ParallelConfig(), device="cpu")
    assert m.param_shapes() == r_flat
    assert any(k.startswith("encoder.") if cfg.enc_seq else k == "patch_proj" for k in r_flat)
    m.init(torch.Generator().manual_seed(0))
    if cfg.enc_seq:
        pos = m.encoder["pos_embed"]
        assert abs(float(pos.std()) * np.sqrt(1500) / 0.02 - 1) < 0.05
        c = m.cache_shape_for("xattn", 2, 40)
        assert c["k"].shape == (2, 40, cfg.n_kv_heads, 16) and c["xk"].shape == (
            2, 1500, cfg.n_kv_heads, 16)
        assert m.cache_logical("xattn")["xk"] == ("batch", None, "kv_heads", None)
    else:
        assert abs(float(m.patch_proj.std()) * np.sqrt(cfg.d_model) - 1) < 0.05


@pytest.mark.parametrize("arch,name", [("whisper-tiny", "frames"), ("internvl2-2b", "patches")])
def test_a_batch_without_frames_or_patches_is_refused(arch, name):
    """The reference fails with ``KeyError`` inside prefill; the port
    refuses with a `ValueError` naming the input."""
    m = port_model(smoke_config(arch))
    tt = torch.as_tensor(tokens(m.cfg, 2, 8), dtype=torch.int64)
    with torch.no_grad(), pytest.raises(ValueError, match=f"batch\\['{name}'\\]"):
        m.prefill(dict(tokens=tt))
    with torch.no_grad(), pytest.raises(ValueError, match=name):
        m.forward(dict(tokens=tt))


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_init_shapes_and_per_leaf_std_follow_the_reference(arch):
    """13 layers: the reference's tree and shapes; every drawn leaf of a
    scanned segment has std 1/sqrt(n_groups), an unscanned one
    1/sqrt(shape[0]); the ``ones`` leaves are ones."""
    from repro.configs import smoke_config as r_smoke

    cfg = dataclasses.replace(smoke_config(arch), n_layers=13)
    r_shapes = RModel(dataclasses.replace(r_smoke(arch), n_layers=13),
                      RParallelConfig()).param_shapes()
    r_flat = {".".join(str(k.key) for k in path): shp
              for path, shp in jax.tree_util.tree_flatten_with_path(
                  r_shapes, is_leaf=lambda t: isinstance(t, tuple))[0]}
    m = Model(cfg, ParallelConfig(), device="cpu")
    assert m.param_shapes() == r_flat
    m.init(torch.Generator().manual_seed(0))
    n_checked = 0
    for path, spec in L.tree_leaves(m.specs()):
        head, _, rest = path.partition(".")
        if not head.startswith("seg"):
            continue
        seg = m.segments[int(head[3:])]
        block, _, leaf = rest.partition(".")
        i = int(block[1:])
        vals = []
        for g in range(seg.n_groups):
            p = m.layers[seg.first_layer + g * len(seg.kinds) + i]
            for name in leaf.split("."):
                p = p[name]
            vals.append(p)
        vals = torch.stack(vals)
        if spec.init == "ones":
            assert bool((vals == 1).all()), path
        elif spec.init == "normal" and vals.numel() >= 1000:
            assert abs(float(vals.std()) / spec.std() - 1) < 0.05, path
            n_checked += 1
    assert n_checked >= 3


@pytest.mark.parametrize("arch", RECURRENT + MOE[:1])
def test_bf16_model_keeps_the_fp32_params(arch):
    """``param_dtype=bfloat16`` draws each leaf in fp32 and casts it on the
    way in: bit-equal to an fp32 ``init`` followed by ``cast``.  The named
    fp32 leaves stay fp32, every other param is bf16, and the bf16 model
    serves (prefill + decode) with finite logits and fp32 states."""
    cfg = smoke_config(arch)
    a = Model(cfg, ParallelConfig(), device="cpu", param_dtype=torch.bfloat16)
    a.init(torch.Generator().manual_seed(0))
    b = Model(cfg, ParallelConfig(), device="cpu").init(torch.Generator().manual_seed(0))
    b.cast(torch.bfloat16)
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    n_fp32 = 0
    for name, t in pa.items():
        want = torch.float32 if keeps_fp32(name) else torch.bfloat16
        assert t.dtype == pb[name].dtype == want, name
        assert torch.equal(t, pb[name]), name
        n_fp32 += want == torch.float32
    assert n_fp32 == sum(n.startswith(kind + ".") for kind in cfg.layer_kinds
                         for n in FP32_PARAMS)
    B, (S, P) = 2, lengths(arch)
    tt = torch.as_tensor(tokens(cfg, B, S), dtype=torch.int64)
    with torch.no_grad():
        last, caches = a.prefill(dict(tokens=tt[:, :P]))
        caches = align_prefill_caches(a, caches, P, S, batch=B)
        lg, caches = a.decode_step(caches, tt[:, P], P)
    assert last.dtype == lg.dtype == torch.bfloat16
    assert bool(torch.isfinite(lg[:, :cfg.vocab_size]).all())
    for c in caches:
        if "state" in c:
            assert c["state"].dtype == torch.float32 and c["conv"].dtype == torch.bfloat16
