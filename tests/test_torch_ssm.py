"""The port's recurrent blocks (``repro_torch.models.ssm``) against the
reference's ``models/ssm.py``, function by function, in fp32 at smoke
widths.

Params and inputs are drawn from a seed with numpy (every leaf random,
the fp32 gate leaves included, so no init value hides a term) and go
through both packages.  Outputs and states agree within ``1e-5`` of
their own scale (fp32; the gap is summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RS
from repro_torch.configs import smoke_config
from repro_torch.models import ssm as S

REL = 1e-5


def jit(fn, *static):
    """The reference function under ``jax.jit`` (as its model runs it), the
    config and chunk static."""
    return jax.jit(fn, static_argnames=static)


def close(got, want, rel=REL):
    """|got - want| <= rel * max|want| (elementwise, both as numpy)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def rand_params(specs, rng):
    """A numpy leaf per spec: weights ~ N(0, 1/fan_in), vectors ~ N(0, 0.5)."""
    out = {}
    for name, spec in specs.items():
        fan_in = spec.shape[0] if len(spec.shape) > 1 else 4
        out[name] = (rng.standard_normal(spec.shape) / np.sqrt(fan_in)).astype(np.float32)
    return out


def as_torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def as_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def x_in(rng, b, s, d):
    return rng.standard_normal((b, s, d)).astype(np.float32)


MAMBA = smoke_config("mamba2-780m")  # d 64, d_inner 128, state 16, 8 heads of 16, chunk 8
RG = smoke_config("recurrentgemma-9b")  # d 64, lru_width 64


def test_specs_equal_the_references():
    for cfg, port, ref in ((MAMBA, S.mamba2_specs, RS.mamba2_specs),
                           (RG, S.rglru_specs, RS.rglru_specs)):
        got, want = port(cfg), ref(cfg)
        assert list(got) == list(want)
        for name in want:
            assert got[name].shape == want[name].shape, name
            assert got[name].init == want[name].init, name


def ssd_inputs(rng, b, s, h=4, p=8, n=16):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus > 0
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bb, cc


@pytest.mark.parametrize("s,chunk", [(8, 8), (24, 8), (6, 6)])
def test_ssd_chunked_equals_the_reference(s, chunk):
    """One chunk (s == chunk), three chunks (s = 3 chunk), and a short
    sequence scanned as one chunk of its own length (what
    ``mamba2_forward`` does when s < ssm_chunk)."""
    args = ssd_inputs(np.random.default_rng(s), 2, s)
    y, state = S._ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    ry, rstate = jit(RS._ssd_chunked, "chunk")(*map(jnp.asarray, args), chunk=chunk)
    close(y, ry)
    close(state, rstate)
    assert state.dtype == torch.float32


def test_ssd_chunk_must_divide_the_length():
    """s = 20 > chunk 8 and not a multiple: the reference's reshape fails,
    the port raises a ValueError naming the chunk."""
    args = ssd_inputs(np.random.default_rng(0), 1, 20)
    with pytest.raises(Exception):
        RS._ssd_chunked(*map(jnp.asarray, args), chunk=8)
    with pytest.raises(ValueError, match="SSD chunk 8"):
        S._ssd_chunked(*map(torch.from_numpy, args), chunk=8)
    p = as_torch(rand_params(S.mamba2_specs(MAMBA), np.random.default_rng(0)))
    with pytest.raises(ValueError, match="SSD chunk 8"):
        S.mamba2_forward(p, torch.zeros((1, 20, MAMBA.d_model)), MAMBA)


@pytest.mark.parametrize("s", [5, 8, 24])
def test_mamba2_forward_equals_the_reference(s):
    """s < chunk (one chunk of length s), s == chunk, s = 3 chunk; the
    output and the prefill cache (conv inputs, fp32 SSD state)."""
    rng = np.random.default_rng(s)
    params = rand_params(S.mamba2_specs(MAMBA), rng)
    x = x_in(rng, 2, s, MAMBA.d_model)
    out, cache = S.mamba2_forward(as_torch(params), torch.from_numpy(x), MAMBA)
    r_out, (r_conv, r_state) = jit(RS.mamba2_forward, "cfg")(
        as_jax(params), jnp.asarray(x), cfg=MAMBA)
    close(out, r_out)
    close(cache["conv"], r_conv)
    close(cache["state"], r_state)
    assert cache["state"].dtype == torch.float32


def test_mamba2_decode_equals_the_reference_and_writes_in_place():
    rng = np.random.default_rng(1)
    params = rand_params(S.mamba2_specs(MAMBA), rng)
    di, n = MAMBA.d_inner, MAMBA.ssm_state
    nh = di // MAMBA.ssm_head_dim
    conv = rng.standard_normal((2, MAMBA.conv_width - 1, di + 2 * n)).astype(np.float32)
    state = rng.standard_normal((2, nh, MAMBA.ssm_head_dim, n)).astype(np.float32)
    x = x_in(rng, 2, 1, MAMBA.d_model)
    cache = dict(conv=torch.from_numpy(conv.copy()), state=torch.from_numpy(state.copy()))
    ids = {k: v.data_ptr() for k, v in cache.items()}
    out, got = S.mamba2_decode(as_torch(params), torch.from_numpy(x), MAMBA, cache)
    r_out, (r_conv, r_state) = jit(RS.mamba2_decode, "cfg")(
        as_jax(params), jnp.asarray(x), cfg=MAMBA, state=(jnp.asarray(conv), jnp.asarray(state)))
    close(out, r_out)
    close(got["conv"], r_conv)
    close(got["state"], r_state)
    assert {k: v.data_ptr() for k, v in got.items()} == ids


@pytest.mark.parametrize("s,chunk", [(16, 512), (24, 8), (20, 8)])
def test_rglru_scan_equals_the_reference_in_both_forms(s, chunk):
    """The flat scan (s <= chunk; s = 20 not a multiple of 8) and the
    chunked one (s = 24 = 3 chunks of 8)."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 16)).astype(np.float32)
    b = rng.standard_normal((2, s, 16)).astype(np.float32)
    a_cum, h = S._rglru_scan(torch.from_numpy(a), torch.from_numpy(b), chunk=chunk)
    ra, rh = jit(RS._rglru_scan, "chunk")(jnp.asarray(a), jnp.asarray(b), chunk=chunk)
    close(a_cum, ra)
    close(h, rh)
    # and against the recurrence itself
    want = np.zeros((2, 16), np.float32)
    for t in range(s):
        want = a[:, t] * want + b[:, t]
    close(h[:, -1], want)


@pytest.mark.parametrize("s", [2, 16])
def test_rglru_forward_equals_the_reference(s):
    """s = 2 < conv_width - 1: the conv state keeps one zero of the pad."""
    rng = np.random.default_rng(s)
    params = rand_params(S.rglru_specs(RG), rng)
    x = x_in(rng, 2, s, RG.d_model)
    out, cache = S.rglru_forward(as_torch(params), torch.from_numpy(x), RG)
    r_out, (r_conv, r_state) = jit(RS.rglru_forward, "cfg")(
        as_jax(params), jnp.asarray(x), cfg=RG)
    close(out, r_out)
    close(cache["conv"], r_conv)
    close(cache["state"], r_state)
    assert cache["state"].dtype == torch.float32


def test_rglru_decode_equals_the_reference_and_writes_in_place():
    rng = np.random.default_rng(2)
    params = rand_params(S.rglru_specs(RG), rng)
    w = RG.lru_width
    conv = rng.standard_normal((2, RG.conv_width - 1, w)).astype(np.float32)
    state = rng.standard_normal((2, w)).astype(np.float32)
    x = x_in(rng, 2, 1, RG.d_model)
    cache = dict(conv=torch.from_numpy(conv.copy()), state=torch.from_numpy(state.copy()))
    ids = {k: v.data_ptr() for k, v in cache.items()}
    out, got = S.rglru_decode(as_torch(params), torch.from_numpy(x), RG, cache)
    r_out, (r_conv, r_state) = jit(RS.rglru_decode, "cfg")(
        as_jax(params), jnp.asarray(x), cfg=RG, state=(jnp.asarray(conv), jnp.asarray(state)))
    close(out, r_out)
    close(got["conv"], r_conv)
    close(got["state"], r_state)
    assert {k: v.data_ptr() for k, v in got.items()} == ids


@pytest.mark.parametrize("block", ["mamba2", "rglru"])
def test_decode_steps_continue_the_forward(block):
    """In the port alone: forward over 8 tokens, then 8 decode steps from
    its cache, equal the forward over all 16 (the reference's chunked vs
    recurrent forms agree)."""
    cfg = MAMBA if block == "mamba2" else RG
    specs = S.mamba2_specs(cfg) if block == "mamba2" else S.rglru_specs(cfg)
    fwd = S.mamba2_forward if block == "mamba2" else S.rglru_forward
    dec = S.mamba2_decode if block == "mamba2" else S.rglru_decode
    rng = np.random.default_rng(3)
    p = as_torch(rand_params(specs, rng))
    x = torch.from_numpy(x_in(rng, 2, 16, cfg.d_model))
    full, _ = fwd(p, x, cfg)
    _, cache = fwd(p, x[:, :8], cfg)
    steps = []
    for t in range(8, 16):
        y, cache = dec(p, x[:, t:t + 1], cfg, cache)
        steps.append(y)
    close(torch.cat(steps, 1), full[:, 8:].numpy(), rel=1e-5)
