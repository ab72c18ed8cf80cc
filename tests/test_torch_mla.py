"""Multi-head latent attention and the sigmoid router in the port
(`models.layers` ``mla_*`` and ``moe_route``, `models.model`'s ``mla``
block kind), held on the CPU against the benchmark's plain float32
reference (``portbench/reference/mla.py``) on weights drawn from a seed
at a small size: the prefill and the full forward, decode through the
latent cache with left pads, the absorbed decode against the expanded
attention, the router, the loss and its first gradients, the cache's
alignment, the spans, and what the model refuses."""

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import arch, port, weights  # noqa: E402
from portbench.reference import train as plain_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import ModelConfig, ParallelConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.serve.engine import ServeEngine, align_prefill_caches  # noqa: E402

CPU = torch.device("cpu")
#: Moonlight-16B-A3B's block at a small size: 4 heads of 16 + 8 (rope), a
#: 32-wide latent, values of 16, one dense layer then 8 experts (top 2)
#: and one shared, the published router settings
MOE = dict(
    name="tiny-mla", arch="mla", hidden_size=64, intermediate_size=128, num_attention_heads=4,
    num_key_value_heads=4, num_hidden_layers=3, vocab_size=300, hidden_act="silu",
    rope_theta=50000.0, tie_word_embeddings=False, rms_norm_eps=1e-5, vocab_pad_multiple=64,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, q_lora_rank=None,
    n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2, moe_intermediate_size=32,
    first_k_dense_replace=1, scoring_func="sigmoid", topk_method="noaux_tc", n_group=1,
    topk_group=1, norm_topk_prob=True, routed_scaling_factor=2.446, router_bias_std=0.05,
    capacity_factor=1.25)
DENSE = dict(MOE, name="tiny-mla-dense", num_hidden_layers=2, n_routed_experts=0)
CONFIGS = {"moe": MOE, "dense": DENSE}
#: float32 on both sides: the gaps read 1e-6 to 3e-6 of logits of order 4
TOL = 2e-5


def build(config, seed=1, compute=torch.float32):
    """``(numbers, model, weights, reference)``: the port's model in float32
    params loaded with the benchmark's draw, and the same draw for the
    reference."""
    a = arch.from_dict(config)
    m = Model(arch.module(a).model_config(a), ParallelConfig(), q_chunk=8, kv_chunk=8,
              device=CPU, compute_dtype=compute)
    port.load(m, a, seed, torch.float32)
    return a, m, dict(weights.draw(a, seed, CPU, torch.float32)), arch.reference(a)


def ids(shape, seed=0):
    return torch.randint(1, MOE["vocab_size"], shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_prefill_and_forward_equal_the_reference(kind):
    a, m, W, ref = build(CONFIGS[kind])
    toks = ids((3, 16))
    with torch.no_grad():
        full, _ = m(dict(tokens=toks))
        last, caches = m.prefill(dict(tokens=toks))
        want = ref.unembed(a, W, ref.hidden(a, W, toks), False)
    torch.testing.assert_close(full[..., :a.vocab_size], want, atol=TOL, rtol=0)
    torch.testing.assert_close(last[:, :a.vocab_size], want[:, -1], atol=TOL, rtol=0)
    assert [sorted(c) for c in caches] == [["c", "kr"]] * a.n_layers
    assert caches[0]["c"].shape == (3, 16, 32) and caches[0]["kr"].shape == (3, 16, 8)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_decode_through_the_latent_cache_equals_the_full_forward(kind):
    """Left-padded prompts, the prefill, then 8 decode steps through the
    engine: every step's logits are the reference's at that position over
    the padded prompts and the tokens fed back (an MoE's routing groups as
    served)."""
    a, m, W, ref = build(CONFIGS[kind])
    pad, new = 12, 9
    rng = np.random.default_rng(0)
    prompts = np.zeros((4, pad), np.int32)
    for i, n in enumerate((12, 5, 8, 3)):
        prompts[i, pad - n:] = rng.integers(1, a.vocab_size, n)
    got, prefill, step = [], m.prefill, m.decode_step

    def rec_prefill(batch):
        logits, caches = prefill(batch)
        got.append(logits)
        return logits, caches

    def rec_step(caches, tok, pos):
        logits, caches = step(caches, tok, pos)
        got.append(logits)
        return logits, caches

    m.prefill, m.decode_step = rec_prefill, rec_step
    out = ServeEngine(m, batch=4, max_seq=pad + new + 3, device=CPU).generate(prompts, new)
    toks = torch.as_tensor(np.concatenate([prompts, out[:, :-1]], 1), dtype=torch.int64)
    with torch.no_grad():
        want = ref.served_logits(a, W, toks, pad)
    assert len(got) == new
    torch.testing.assert_close(torch.stack(got, 1)[..., :a.vocab_size], want, atol=TOL, rtol=0)


def test_absorbed_decode_equals_the_expanded_attention():
    """One layer in float32: `mla_decode` at position 12 over a cache the
    prefill of 12 positions filled gives `mla_train`'s output at 12, and
    appends the same latent and rotary key."""
    a, m, _, _ = build(MOE)
    p, cfg = m.layers[1]["attn"], m.cfg
    x = torch.randn(2, 13, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full, (c_full, kr_full) = L.mla_train(p, x, cfg, 8, 8)
        _, (c, kr) = L.mla_train(p, x[:, :12], cfg, 8, 8)
        cache = dict(c=torch.zeros(2, 16, 32), kr=torch.zeros(2, 16, 8))
        cache["c"][:, :12], cache["kr"][:, :12] = c, kr
        out, cache = L.mla_decode(p, x[:, 12:], cfg, cache, 12)
    torch.testing.assert_close(out, full[:, 12:], atol=1e-5, rtol=0)
    torch.testing.assert_close(cache["c"][:, :13], c_full, atol=1e-6, rtol=0)
    torch.testing.assert_close(cache["kr"][:, :13], kr_full, atol=1e-6, rtol=0)
    assert not cache["c"][:, 13:].any()
    with pytest.raises(IndexError, match="beyond the cache's 16 slots"):
        L.mla_decode(p, x[:, 12:], cfg, cache, 16)


ROUTER = ModelConfig(name="router", family="moe", n_layers=1, d_model=16, n_heads=1,
                     n_kv_heads=1, d_ff=8, vocab_size=8, n_experts=8, top_k=2, moe_d_ff=8,
                     router_scoring="sigmoid", routed_scale=2.446)


def _route(logits, bias):
    """`moe_route` of one group whose router logits are ``logits`` (N, 8):
    the tokens are the identity's rows."""
    n = logits.shape[0]
    xt = torch.zeros(1, n, 16)
    xt[0, :, :n] = torch.eye(n)
    router = torch.zeros(16, 8)
    router[:n] = logits
    return L.moe_route(dict(router=router, router_bias=bias), xt, ROUTER)


@pytest.mark.parametrize("case", ["bias_moves_choice", "gates_renormalized_and_scaled", "ties",
                                  "capacity_drops"])
def test_sigmoid_router(case):
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(4, 8, generator=g)
    scores = torch.sigmoid(logits)
    if case == "bias_moves_choice":
        no_bias = _route(logits, torch.zeros(8))
        loser = int(scores[0].argmin())
        bias = torch.zeros(8)
        bias[loser] = 5.0
        r = _route(logits, bias)
        assert loser not in no_bias.expert_idx[0, 0] and loser in r.expert_idx[0, 0]
        # the gates are the unbiased scores of the chosen experts
        chosen = scores[0].gather(-1, r.expert_idx[0, 0])
        torch.testing.assert_close(r.gate_vals[0, 0], chosen / chosen.sum() * 2.446)
    elif case == "gates_renormalized_and_scaled":
        r = _route(logits, torch.zeros(8))
        want = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :2]
        assert torch.equal(r.expert_idx[0], want)
        torch.testing.assert_close(r.gate_vals[0].sum(-1), torch.full((4,), 2.446))
        torch.testing.assert_close(r.probs[0], scores / scores.sum(-1, keepdim=True))
    elif case == "ties":
        tied = torch.full((4, 8), -3.0)
        tied[:, 5] = tied[:, 2] = tied[:, 6] = 1.0
        r = _route(tied, torch.zeros(8))
        assert r.expert_idx[0].tolist() == [[2, 5]] * 4  # the lower index first
        bias = torch.zeros(8)
        bias[6] = 1e-3
        assert _route(tied, bias).expert_idx[0].tolist() == [[6, 2]] * 4
    else:
        many = torch.randn(40, 8, generator=g)
        bias = torch.zeros(8)
        bias[3] = bias[7] = 10.0  # every token picks 3 and 7
        r = _route(many[:16], bias)  # 16 of them: a capacity of ceil(16 * 2 / 8 * 1.25) = 5 -> 8
        assert r.cap == 8
        assert (r.expert_idx[0].sort(-1).values == torch.tensor([3, 7])).all()
        # each expert keeps its first 8 tokens in token order and drops the rest
        assert int(r.keep.sum()) == 16 and int((~r.keep).sum()) == 16
        kept_tokens = (r.order[0][r.keep[0]] // 2).view(2, 8)
        assert kept_tokens.tolist() == [list(range(8))] * 2


def test_moe_layer_with_drops_equals_the_reference():
    """One MoE layer, float32, a selection bias that sends every token to
    the same two experts: the port's `moe_ffn` (capacity drops, gates from
    the unbiased scores, the scale, the shared expert) against the
    reference's."""
    a, m, W, ref = build(MOE)
    W["router_bias"][0] = torch.tensor([0, 8.0, 0, 0, 0, 0, 8.0, 0])
    m.layers[1]["moe"]["router_bias"].data.copy_(W["router_bias"][0])
    h = torch.randn(3, 10, 64, generator=torch.Generator().manual_seed(4))
    trace.reset()
    trace.enable()
    try:
        with torch.no_grad():
            got, _ = L.moe_ffn(m.layers[1]["moe"], h, m.cfg)
            want = ref.moe_ffn(a, W, 0, h, 10, False)
        counted = trace.collect()["counters"]
    finally:
        trace.disable()
        trace.reset()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert counted["moe.assignments"] == 60 and counted["moe.dropped"] == 60 - 2 * a.capacity(30)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_loss_and_first_gradients_equal_the_training_reference(kind):
    """`Model.loss_fn` (aux weight 0: the published model's balance loss is
    not the port's) and its gradients, against the reference's cross
    entropy: `reference.train` for the dense model (it trains one sequence
    at a time), the MoE's over the whole batch as one routing group, as
    the port's training step routes it."""
    a, m, W, ref = build(CONFIGS[kind])
    toks = ids((2, 17), seed=2)
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    params = m.train_params()
    loss, _ = m.loss_fn(batch, aux_weight=0.0)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))
    W = {k: v.requires_grad_(True) for k, v in W.items()}
    if a.is_moe:
        logits = ref.unembed(a, W, ref.hidden(a, W, batch["tokens"]), False)
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, batch["labels"][..., None])[..., 0]
        want = nll.mean()
        want.backward()
        want = float(want.detach())
    else:
        want = plain_train.loss_and_grads(a, W, batch["tokens"], batch["labels"])
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    name = arch.module(a).param_name
    for key, kind_, i in weights.leaves(a):
        if kind_ == "router_bias":  # it moves the choice only: no gradient reaches it
            assert grads[name(a, kind_, i)] is None and W[kind_].grad is None
            continue
        g = W[kind_].grad if i is None else W[kind_].grad[i]
        torch.testing.assert_close(grads[name(a, kind_, i)], g, atol=2e-5, rtol=1e-3, msg=key)


def test_align_prefill_caches_pads_the_latent_cache():
    a, m, _, _ = build(MOE)
    with torch.no_grad():
        _, caches = m.prefill(dict(tokens=ids((2, 6))))
    out = align_prefill_caches(m, caches, 6, 10, batch=2)
    for pre, post in zip(caches, out):
        assert post["c"].shape == (2, 10, 32) and post["kr"].shape == (2, 10, 8)
        assert torch.equal(post["c"][:, :6], pre["c"]) and not post["c"][:, 6:].any()
        assert torch.equal(post["kr"][:, :6], pre["kr"]) and not post["kr"][:, 6:].any()
    with pytest.raises(ValueError, match="batch 2 != 3"):
        align_prefill_caches(m, caches, 6, 10, batch=3)


def test_the_latent_attention_spans_nest_under_block_attn():
    a, m, _, _ = build(MOE)
    trace.reset()
    trace.enable()
    try:
        with torch.no_grad():
            _, caches = m.prefill(dict(tokens=ids((2, 6))))
            caches = align_prefill_caches(m, caches, 6, 8, batch=2)
            m.decode_step(caches, ids((2,)), 6)
        rec = trace.collect()
    finally:
        trace.disable()
        trace.reset()
    by_id = {s["id"]: s for s in rec["spans"]}
    mla = [s for s in rec["spans"] if s["name"].startswith("mla.")]
    assert {s["name"] for s in mla} == {"mla.project", "mla.attend", "mla.out"}
    assert {s["name"] for s in mla} <= set(trace.SPANS)
    assert all(by_id[s["parent"]]["name"] == "block.attn" for s in mla)
    assert len(mla) == 2 * 3 * a.n_layers  # prefill and one step, three spans a layer
    step = [s for s in mla if s["name"] == "mla.attend" and s["attrs"]]
    assert [s["attrs"] for s in step] == [dict(rows=2, slots=7)] * a.n_layers


def test_the_mesh_path_refuses_the_kind_and_an_unknown_kind_is_named():
    a = arch.from_dict(MOE)
    with pytest.raises(NotImplementedError, match="mesh path does not run the 'mla'"):
        Model(arch.module(a).model_config(a), mesh=object(), device=CPU)
    bad = ModelConfig(name="bad", family="dense", n_layers=1, d_model=8, n_heads=1, n_kv_heads=1,
                      d_ff=8, vocab_size=8, pattern=("nope",))
    with pytest.raises(ValueError, match="unknown block kind 'nope'"):
        Model(bad, device=CPU)


@pytest.mark.parametrize("kind,builds", [("mla", False), ("attn", True)])
def test_prefill_starts_the_decode_kernel_build_only_for_its_kinds(monkeypatch, kind, builds):
    calls = []
    monkeypatch.setattr(L, "prefetch_decode_kernel", lambda *a, **k: calls.append(1))
    a = arch.from_dict(MOE)
    cfg = arch.module(a).model_config(a)
    if kind == "attn":
        cfg = ModelConfig(name="attn", family="dense", n_layers=1, d_model=64, n_heads=4,
                          n_kv_heads=4, d_ff=64, vocab_size=300, vocab_pad_multiple=64)
    m = Model(cfg, device=CPU, q_chunk=8, kv_chunk=8)
    with torch.no_grad():
        m.prefill(dict(tokens=ids((1, 8))))
    assert bool(calls) == builds


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_parameter_counts_take_in_the_latent_attention(kind):
    a, m, _, _ = build(CONFIGS[kind])
    cfg = m.cfg
    pad_rows = 2 * (a.padded_vocab - a.vocab_size) * a.d_model
    held = sum(p.numel() for p in m.parameters()) - pad_rows - a.d_model  # n_params: no final norm
    assert cfg.n_params() == held
    routed = a.moe_layers * (a.n_experts - a.top_k) * 3 * a.d_model * a.moe_d_ff
    assert cfg.n_active_params() == held - routed


def test_a_bf16_model_keeps_the_selection_bias_in_fp32():
    a = arch.from_dict(MOE)
    m = Model(arch.module(a).model_config(a), device=CPU, param_dtype=torch.bfloat16)
    dtypes = {n: p.dtype for n, p in m.named_parameters()}
    assert dtypes["layers.1.moe.router_bias"] == torch.float32
    assert dtypes["layers.1.attn.kv_norm"] == dtypes["layers.1.moe.router"] == torch.bfloat16

