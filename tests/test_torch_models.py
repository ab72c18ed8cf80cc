"""The port's dense LM (``repro_torch.models``) against the reference's.

Params come from the reference's ``Model.init`` and cross over as numpy
through ``params_from_reference``; token inputs are made from a seed with
numpy.  Compute is fp32 in both packages.  Parity tolerances: logits
within ``atol=2e-4`` (their scale is 1-5 here; the measured gap is
1e-6-3e-5, summation order), caches within ``rtol=1e-4`` of their own
scale.  The port-alone checks keep the reference's own tolerances
(2e-3 prefill, 5e-3 decode; ``tests/test_models.py``).
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
from repro_torch.models.config import ParallelConfig
from repro_torch.models.interop import caches_from_reference, params_from_reference
from repro_torch.models.model import Model, build_segments, model_specs
from repro_torch.serve.engine import align_prefill_caches

DENSE = ("minicpm-2b", "qwen1.5-4b", "gemma3-27b", "deepseek-coder-33b")
LOGIT_ATOL = 2e-4


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


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


def same_caches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("k", "v"):
            scale = float(w[name].abs().max())
            torch.testing.assert_close(g[name], w[name], rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_caches_and_decode_equal_the_reference(arch):
    """Teacher-forced logits, prefill logits and caches, the aligned caches
    and 8 decode steps.  Prompt 20 > gemma3's smoke window 16, so its ring
    caches are cut to the window and rotated by 4."""
    rm, params = ref_model(arch)
    pm = port_model(smoke_config(arch), params)
    B, S, P = 2, 28, 20
    toks = tokens(pm.cfg, B, S)

    r_full, _ = jax.jit(rm.forward)(params, dict(tokens=jnp.asarray(toks)))
    r_last, r_caches = jax.jit(rm.prefill)(params, dict(tokens=jnp.asarray(toks[:, :P])))
    r_aligned = r_align(rm, r_caches, P, S, batch=B)
    decode = jax.jit(rm.decode_step)
    r_steps, cur = [], r_aligned
    for t in range(P, S):
        lg, cur = decode(params, cur, jnp.asarray(toks[:, t]), jnp.int32(t))
        r_steps.append(np.asarray(lg))

    tt = torch.as_tensor(toks, dtype=torch.int64)
    with torch.no_grad():
        full, aux = pm.forward(dict(tokens=tt))
        np.testing.assert_allclose(full.numpy(), np.asarray(r_full), atol=LOGIT_ATOL, rtol=0)
        assert float(aux) == 0.0
        last, caches = pm.prefill(dict(tokens=tt[:, :P]))
        np.testing.assert_allclose(last.numpy(), np.asarray(r_last), atol=LOGIT_ATOL, rtol=0)
        same_caches(caches, caches_from_reference(pm, jax.tree.map(np.asarray, r_caches)))
        caches = align_prefill_caches(pm, caches, P, S, batch=B)
        same_caches(caches, caches_from_reference(pm, jax.tree.map(np.asarray, r_aligned)))
        for i, t in enumerate(range(P, S)):
            lg, caches = pm.decode_step(caches, tt[:, t], t)
            np.testing.assert_allclose(lg.numpy(), r_steps[i], atol=LOGIT_ATOL, rtol=0)


def decode_against_forward(m, B, S, P):
    tt = torch.as_tensor(tokens(m.cfg, B, S), dtype=torch.int64)
    with torch.no_grad():
        full, _ = m.forward(dict(tokens=tt))
        last, caches = m.prefill(dict(tokens=tt[:, :P]))
        caches = align_prefill_caches(m, caches, P, S, batch=B)
        prefill_err = float((last - full[:, P - 1]).abs().max())
        worst = 0.0
        for t in range(P, S):
            lg, caches = m.decode_step(caches, tt[:, t], t)
            worst = max(worst, float((lg - full[:, t]).abs().max()))
    return prefill_err, worst


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Serving correctness in the port alone (``tests/test_models.py:53``):
    prefill + decode logits == the teacher-forced forward."""
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


@pytest.mark.parametrize("arch,feature", [
    ("mamba2-780m", "ssm"),
    ("recurrentgemma-9b", "rglru"),
    ("whisper-tiny", "xattn"),
    ("deepseek-moe-16b", "MoE"),
    ("internvl2-2b", "n_patches"),
])
def test_out_of_slice_configs_raise(arch, feature):
    with pytest.raises(NotImplementedError, match=feature):
        Model(smoke_config(arch), device="cpu")
