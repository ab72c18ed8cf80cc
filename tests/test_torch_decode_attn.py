"""The port's decode attention on the CPU: the plain path with RoPE split
off the projections against today's eager code, the host side of the
hand kernel (its slot window, launch plan and operand checks), the trace
counter of its launches and the background build.

The kernel itself runs only on a card (``tests/test_torch_cuda.py``, marker
``cuda``).  Inputs are made from a seed; the CPU path must equal the eager
code it replaced bit for bit, outputs and caches.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attn as DA
from repro_torch.models import layers as L
from repro_torch.models.config import ParallelConfig
from repro_torch.models.model import Model
from repro_torch.runtime import trace
from repro_torch.serve.engine import align_prefill_caches


def _attention_decode_before(p, x, cfg, kind, theta, cache, pos):
    """`layers.attention_decode` as it was before RoPE moved off the
    projections (off a mesh), for the bit-for-bit checks."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = x @ p["wq"].to(x.dtype)
    k_new = x @ p["wk"].to(x.dtype)
    v_new = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k_new = k_new + p["bk"].to(x.dtype)
        v_new = v_new + p["bv"].to(x.dtype)
    q = q.reshape(b, 1, cfg.n_heads, hd)
    k_new = k_new.reshape(b, 1, cfg.n_kv_heads, hd)
    v_new = v_new.reshape(b, 1, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k_new = L.rms_norm(k_new, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, theta)
    k_new = L.apply_rope(k_new, positions, theta)

    s_cache = cache["k"].shape[1]
    is_ring = kind == "local" and cfg.window and cfg.window < 10**9 and s_cache <= cfg.window
    slot = pos % s_cache if is_ring else pos
    k, v = cache["k"], cache["v"]
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = 1.0 / math.sqrt(hd)
    kk = L._repeat_kv(k, n_rep)
    vv = L._repeat_kv(v, n_rep)
    s_ = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), kk.float())
    kv_idx = torch.arange(s_cache, device=q.device)
    if is_ring:
        age = torch.remainder(pos - kv_idx, s_cache)
        valid = age < min(pos + 1, cfg.window)
    else:
        valid = kv_idx <= pos
        if kind == "local" and cfg.window:
            valid &= kv_idx > pos - cfg.window
    s_ = torch.where(valid[None, None, None, :], s_, L.NEG)
    prob = torch.softmax(s_, dim=-1).to(vv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", prob, vv)
    out = out.reshape(b, 1, cfg.n_heads * hd).to(x.dtype)
    return out @ p["wo"].to(x.dtype), cache


#: (id, arch, kind, config overrides, cache slots, pos): every zoo attention kind
ZOO_KINDS = [
    ("minicpm-mha", "minicpm-2b", "attn", {}, 24, 19),
    ("qwen-qkv-bias", "qwen1.5-4b", "attn", {}, 24, 20),
    ("gemma3-global-qk-norm-gqa", "gemma3-27b", "attn", {}, 24, 21),
    ("gemma3-local-ring-before-wrap", "gemma3-27b", "local", {}, 16, 9),
    ("gemma3-local-ring-after-wrap", "gemma3-27b", "local", {}, 16, 37),
    ("gemma3-local-windowed-not-ring", "gemma3-27b", "local", {}, 40, 33),
    ("recurrentgemma-mqa-local", "recurrentgemma-9b", "local", {}, 16, 30),
    ("deepseek-coder-gqa7", "deepseek-coder-33b", "attn", dict(n_heads=14, n_kv_heads=2),
     24, 22),
    ("whisper-self-attention", "whisper-tiny", "attn", {}, 24, 5),
    ("internvl2-after-patch-prefix", "internvl2-2b", "attn", {}, 48, 8 + 20),
]


def _attn_params(cfg, gen):
    p = L.ParamTree(L.attention_specs(cfg), torch.device("cpu"))
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.randn(t.shape, generator=gen) * 0.2)
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ZOO_KINDS, ids=[c[0] for c in ZOO_KINDS])
def test_decode_path_with_rope_split_off_equals_the_eager_code(case, dtype):
    """`attention_decode` on the CPU (RoPE applied in the decode path,
    after `layers._project`) gives the eager code's outputs and caches bit
    for bit, for each zoo attention kind."""
    _, arch, kind, over, s, pos = case
    cfg = dataclasses.replace(smoke_config(arch), **over)
    gen = torch.Generator().manual_seed(pos)
    p = _attn_params(cfg, gen)
    b, hd = 3, cfg.resolved_head_dim
    x = torch.randn((b, 1, cfg.d_model), generator=gen).to(dtype)
    cache = dict(k=torch.randn((b, s, cfg.n_kv_heads, hd), generator=gen).to(dtype),
                 v=torch.randn((b, s, cfg.n_kv_heads, hd), generator=gen).to(dtype))
    mine = {n: t.clone() for n, t in cache.items()}
    want, _ = _attention_decode_before(p, x, cfg, kind, cfg.rope_theta, cache, pos)
    got, out_cache = L.attention_decode(p, x, cfg, kind, cfg.rope_theta, mine, pos)
    assert out_cache is mine
    assert got.dtype == want.dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    for n in ("k", "v"):
        assert torch.equal(mine[n].view(torch.uint8), cache[n].view(torch.uint8)), n


def test_training_projections_keep_rope_in_place():
    """`_project_qkv` (training, prefill) is `_project` followed by RoPE of
    q and k at the given positions, bit for bit."""
    cfg = smoke_config("gemma3-27b")
    gen = torch.Generator().manual_seed(0)
    p = _attn_params(cfg, gen)
    x = torch.randn((2, 5, cfg.d_model), generator=gen)
    pos = torch.arange(5)[None, :]
    q, k, v = L._project_qkv(p, x, cfg, pos, cfg.rope_theta)
    q0, k0, v0 = L._project(p, x, cfg)
    assert torch.equal(q, L.apply_rope(q0, pos, cfg.rope_theta))
    assert torch.equal(k, L.apply_rope(k0, pos, cfg.rope_theta)) and torch.equal(v, v0)


#: (kind, window, cache slots): the caches `decode_window` maps
WINDOWS = [("attn", 0, 40), ("local", 16, 16), ("local", 16, 10), ("local", 16, 40),
           ("local", 10**9, 24), ("attn", 16, 24)]


@pytest.mark.parametrize("kind,window,s", WINDOWS)
def test_decode_window_selects_the_plain_versions_valid_slots(kind, window, s):
    """The kernel's ``(first, n)`` slots are the plain version's mask at
    every position, the newest last at the new entry's slot; a position
    past a cache that is no ring raises, as the plain append does."""
    cfg = dataclasses.replace(smoke_config("gemma3-27b"), window=window)
    is_ring = kind == "local" and window and window < 10**9 and s <= window
    idx = torch.arange(s)
    for pos in range(3 * s):
        if not is_ring and pos >= s:
            with pytest.raises(IndexError):
                L.decode_window(kind, cfg, s, pos)
            continue
        first, n = L.decode_window(kind, cfg, s, pos)
        if is_ring:
            valid = torch.remainder(pos - idx, s) < min(pos + 1, window)
        else:
            valid = idx <= pos
            if kind == "local" and window:
                valid &= idx > pos - window
        assert {(first + j) % s for j in range(n)} == set(idx[valid].tolist()), pos
        assert (first + n - 1) % s == (pos % s if is_ring else pos)


#: (batch, KV heads, n_rep, head_dim, itemsize, valid slots): zoo and cell shapes
PLANS = [(32, 36, 1, 64, 2, 2112), (256, 16, 1, 128, 2, 320), (4, 16, 2, 128, 2, 701),
         (4, 1, 16, 256, 2, 2048), (40, 8, 7, 128, 2, 4000), (1, 8, 7, 128, 2, 8001),
         (2, 1, 4, 16, 2, 22), (2, 1, 16, 256, 4, 2048), (2, 2, 2, 16, 4, 16),
         (1, 1, 3, 64, 2, 1)]


@pytest.mark.parametrize("shape", PLANS)
def test_launch_plan_covers_the_slots_in_whole_warps(shape):
    """A block is whole warps and whole rows of heads, at most 512
    threads; the chunks cover the valid slots with none empty, each
    chunk's scores fit `SCORE_BYTES`; the two cells run unsplit."""
    b, kv, n_rep, hd, size, n = shape
    threads, n_split, chunk = DA.plan(b, kv, n_rep, hd, size, n, n_sm=132)
    team = n_rep * min(32, hd * size // 16)
    assert threads % 32 == 0 and threads % team == 0 and threads <= DA.MAX_THREADS
    assert (n_split - 1) * chunk < n <= n_split * chunk
    assert n_rep * chunk * 4 <= DA.SCORE_BYTES
    if b * kv >= DA.WAVES * 132 and n_rep * n * 4 <= DA.SCORE_BYTES:
        assert n_split == 1
    elif b * kv < DA.WAVES * 132 and n > DA.MIN_CHUNK:
        assert n_split > 1


@pytest.mark.parametrize("shape", PLANS)
def test_launch_plan_without_the_occupancy_split_splits_only_long_rows(monkeypatch, shape):
    """With ``WAVES = 0`` a row is split only where its scores outgrow
    `SCORE_BYTES`, into as few chunks as fit."""
    b, kv, n_rep, hd, size, n = shape
    monkeypatch.setattr(DA, "WAVES", 0)
    _, n_split, chunk = DA.plan(b, kv, n_rep, hd, size, n, n_sm=132)
    assert n_split == -(-n_rep * n * 4 // DA.SCORE_BYTES)
    assert (n_split - 1) * chunk < n <= n_split * chunk


def test_launch_plan_refuses_blocks_over_the_limit():
    with pytest.raises(build.OperandError):
        DA.plan(1, 1, 17, 256, 2, 100, n_sm=132)


def _operands(dtype=torch.bfloat16, b=2, s=24, kv=2, n_rep=2, hd=64):
    g = torch.Generator().manual_seed(0)
    mk = lambda *shape: torch.randn(shape, generator=g).to(dtype)
    return dict(q=mk(b, 1, kv * n_rep, hd), k_new=mk(b, 1, kv, hd), v_new=mk(b, 1, kv, hd),
                k_cache=mk(b, s, kv, hd), v_cache=mk(b, s, kv, hd),
                inv_freq=L.rope_freqs(hd, 1e4), pos=10, first=0, n_valid=11)


def _bad(name):
    """Operands the kernel does not take, each with one fault."""
    ops = _operands()
    if name == "fp16-cache":
        ops = _operands(torch.float16)
    elif name == "q-in-another-dtype":
        ops["q"] = ops["q"].float()
    elif name == "inv-freq-not-fp32":
        ops["inv_freq"] = ops["inv_freq"].double()
    elif name == "head-dim-48":
        ops = _operands(hd=48)
    elif name == "q-heads-not-a-multiple":
        ops["q"] = ops["q"][:, :, :3]
    elif name == "k-new-shape":
        ops["k_new"] = ops["k_new"][:1]
    elif name == "inv-freq-shape":
        ops["inv_freq"] = ops["inv_freq"][:-1]
    elif name == "q-not-contiguous":
        ops["q"] = ops["q"].transpose(0, 2).contiguous().transpose(0, 2)
    elif name == "cache-heads-not-contiguous":
        ops["k_cache"] = ops["k_cache"].transpose(2, 3).contiguous().transpose(2, 3)
    elif name == "cache-off-16-bytes":
        big = torch.zeros(2 * 24 * 2 * 64 + 1, dtype=torch.bfloat16)
        ops["v_cache"] = big[1:].view(2, 24, 2, 64)
    elif name == "caches-differ":
        ops["v_cache"] = ops["v_cache"][:, :20]
    elif name == "slots-past-the-cache":
        ops["n_valid"] = 25
    elif name == "first-out-of-range":
        ops["first"] = 24
    elif name == "cpu-tensors":
        pass
    return ops


BAD = ["fp16-cache", "q-in-another-dtype", "inv-freq-not-fp32", "head-dim-48",
       "q-heads-not-a-multiple", "k-new-shape", "inv-freq-shape", "q-not-contiguous",
       "cache-heads-not-contiguous", "cache-off-16-bytes", "caches-differ",
       "slots-past-the-cache", "first-out-of-range", "cpu-tensors"]


@pytest.mark.parametrize("fault", BAD)
def test_wrapper_refuses_operands_it_does_not_take(fault):
    """Wrong dtype, shape, layout or slots, and CPU tensors (the plain
    version is `layers.decode_attend`), raise before any launch."""
    before = DA.LAUNCHES["decode_attn"]
    with pytest.raises(build.OperandError):
        DA.decode_attention(**_bad(fault), scale=0.125)
    assert DA.LAUNCHES["decode_attn"] == before


def test_sound_operands_pass_the_checks():
    ops = _operands()
    ops["k_cache"] = torch.randn(2, 30, 2, 64).to(torch.bfloat16)[:, 6:]  # a sliced ring
    ops["v_cache"] = ops["k_cache"].clone()
    DA.check_operands(**ops)


def _tiny(arch):
    cfg = smoke_config(arch)
    return Model(cfg, ParallelConfig(), compute_dtype=torch.float32, q_chunk=8, kv_chunk=8,
                 device="cpu").init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma3-27b"])
def test_kernel_counter_counts_launches_only_while_tracing(monkeypatch, arch):
    """With the kernel path taken (here a stand-in for the launch),
    ``attn.decode_kernel`` counts one per attention layer and step while
    the tracer is on; off, the decode path records nothing."""
    m = _tiny(arch)
    calls = []

    def launch(q, *args, **kw):
        calls.append(q.shape)
        return torch.zeros_like(q)

    monkeypatch.setattr(L, "_uses_kernel", lambda x, constrain_fn: constrain_fn is None)
    monkeypatch.setattr(DA, "decode_attention", launch)
    monkeypatch.setattr(DA, "prefetch", lambda: None)  # no nvcc here
    n_attn = sum(k in ("attn", "local", "xattn") for k in m.kinds)
    b, p = 2, 20
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, m.cfg.vocab_size, (b, p + 2)))
    with torch.inference_mode():
        _, caches = m.prefill(dict(tokens=toks[:, :p]))
        caches = align_prefill_caches(m, caches, p, p + 2, batch=b)
        trace.reset()
        m.decode_step(caches, toks[:, p], p)
        assert len(calls) == n_attn
        assert trace.collect() == dict(spans=[], counters={}, counts=[], dropped=0)
        trace.enable()
        try:
            m.decode_step(caches, toks[:, p + 1], p + 1)
        finally:
            trace.disable()
        rec = trace.collect()
        trace.reset()
    assert len(calls) == 2 * n_attn
    assert rec["counters"]["attn.decode_kernel"] == n_attn
    assert [c[2] for c in rec["counts"] if c[0] == "attn.decode_kernel"] == [1] * n_attn


@pytest.mark.parametrize("arch,starts", [("minicpm-2b", True), ("gemma3-27b", True),
                                         ("mamba2-780m", False)])
def test_prefill_starts_the_kernel_build_where_decode_launches_it(monkeypatch, arch, starts):
    """A prefill starts the kernel's background build once where
    `attention_decode` would launch it (here the CPU stands in for a
    card): a model with attention layers; one of recurrent layers only,
    or on the CPU, starts none."""
    m = _tiny(arch)
    started = []
    monkeypatch.setattr(DA, "prefetch", lambda: started.append(1))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, m.cfg.vocab_size, (2, 16)))
    with torch.inference_mode():
        m.prefill(dict(tokens=toks))
        assert started == []
        monkeypatch.setattr(L, "_uses_kernel", lambda x, constrain_fn: constrain_fn is None)
        m.prefill(dict(tokens=toks))
    assert started == ([1] if starts else [])


def test_tolerance_admits_one_bf16_unit_in_the_last_place_and_no_more():
    """In bf16 `decode_attn.tolerance` admits each output's neighbouring
    values and not the values two units away (beside the mean's share)."""
    g = torch.Generator().manual_seed(0)
    want = (torch.randn(4, 1, 8, 64, generator=g) * 0.05).to(torch.bfloat16)
    tol = DA.tolerance(want, torch.ones(1))
    bits = want.view(torch.int16)
    for step, admitted in ((1, True), (-1, True), (3, False)):
        near = (bits + step).view(torch.bfloat16)
        gap = (near.float() - want.float()).abs()
        assert bool((gap <= tol).all()) == admitted, step
    assert DA.tolerance(want.float(), 3 * torch.ones(1)).max() == 12 * 2.0 ** -23


def test_prefetched_build_is_the_one_load_waits_for(monkeypatch, tmp_path):
    """`build.prefetch` starts one build however often it is called, and
    `load` finishes that build instead of starting another."""
    started, finished = [], []
    lib = tmp_path / "libx.so"
    monkeypatch.setattr(build, "_start", lambda name: started.append(name) or (lib, "proc"))
    monkeypatch.setattr(build, "_finish", lambda name, out, proc: finished.append(proc) or "")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_PENDING", {})
    build.prefetch("x")
    build.prefetch("x")
    assert started == ["x"]
    assert build.load("x") == ("lib", str(lib))
    assert started == ["x"] and finished == ["proc"] and build._PENDING == {}
    build.prefetch("x")  # loaded: nothing to start
    assert started == ["x"]
