"""The latent-attention architecture (``archs/mla.py``, ``reference/mla.py``)
and the Moonlight-16B-A3B configuration, on the CPU: the published numbers
read as run; the leaves, names and counts at the published widths against
numbers worked by hand; the program's model built from it on the meta
device; a tiny serving cell through the cell's driver (`serve_replay`),
whose check passes, whose float8 control fails and which each planted
fault fails; the reference's replay of given choices; the two span
metrics' arithmetic; and the reference's imports.

Worked by hand at the published widths (bfloat16, 2 bytes):

- parameters: the embedding and the head, 2 x 163,840 x 2,048 =
  671,088,640, and the final norm 2,048; a layer's attention 2,048 x 16 x
  192 (q) + 2,048 x 576 (the latent and rotary key) + 512 (the latent's
  norm) + 512 x 16 x 256 (W_UK, W_UV) + 2,048 x 2,048 (o) = 13,763,072,
  and its two norms 4,096, over 27 layers 371,713,536; the dense FFN 3 x
  2,048 x 11,264 = 69,206,016; an MoE layer's router 131,072, bias 64,
  experts 64 x 3 x 2,048 x 1,408 = 553,648,128 and shared experts 3 x
  2,048 x 2,816 = 17,301,504, over 26 layers 14,848,099,968: in all
  15,960,110,208;
- the latent cache at 256 x 896 slots: 27 x 256 x 896 x 576 x 2 =
  7,134,511,104 bytes (a per-head cache, 16 x (192 + 128) a slot:
  63,417,876,480);
- the routed experts a decode step reads with all 64 hit: 26 x 553,648,128
  x 2 = 28,789,702,656 bytes;
- one token's decode at one attended slot: twice its matmul weights, 27 x
  13,762,560 + 69,206,016 + 26 x (131,072 + 3 x 2,048 x 1,408 x 8) =
  2,243,559,424, plus 27 x 16 x 2 x (576 + 512) = 940,032 of attention and
  2 x 2,048 x 163,840 = 671,088,640 of logits: 5,159,147,520.
"""

import copy
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from portbench import arch, counts, harness, spans, weights
from portbench.tests import tiny

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CONFIG = "moonlight-16b-a3b"

#: Moonlight's block at a small size (tests/test_torch_mla.py's)
TINY = dict(
    name="tiny-mla", arch="mla", hidden_size=64, intermediate_size=128, num_attention_heads=4,
    num_key_value_heads=4, num_hidden_layers=3, vocab_size=300, hidden_act="silu",
    rope_theta=50000.0, tie_word_embeddings=False, rms_norm_eps=1e-5, vocab_pad_multiple=64,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2, moe_intermediate_size=32,
    first_k_dense_replace=1, routed_scaling_factor=2.446, router_bias_std=0.05,
    capacity_factor=1.25)
#: the tiny cell, checked as Moonlight's (the program's choices replayed).  Its
#: limits: sound runs read a mean gap of 0-0.0017 and miss 0-3.4% of their
#: choices, the float8 control 0.003-0.034 and 1.4-17.6% (seeds 1-20); the
#: faults below 0.03-0.26 (gates, rotary key) or 7.1-25.9% (bias) (seeds
#: 1-6; CPU, torch 2.13)
SERVE = dict(copy.deepcopy(tiny.SERVE_MOE), name="tiny-mla.serve", driver="serve_replay",
             weights={}, check=dict(limits=dict(logit_gap_mean=0.0025, route_miss_pct=5.0)))


def test_the_configuration_holds_the_published_numbers():
    c = arch.load_dict(CONFIG)
    a = arch.from_dict(c)
    assert a.arch == "mla" and c["reduced"] == []
    assert (a.n_layers, a.d_model, a.n_heads, a.kv_lora_rank, a.qk_nope_head_dim,
            a.qk_rope_head_dim, a.v_head_dim) == (27, 2048, 16, 512, 128, 64, 128)
    assert (a.d_ff, a.first_dense_layers, a.n_experts, a.top_k, a.n_shared_experts,
            a.moe_d_ff) == (11264, 1, 64, 6, 2, 1408)
    assert (a.vocab_size, a.padded_vocab, a.tie_embeddings) == (163840, 163840, False)
    assert (a.routed_scale, a.norm_eps, a.rope_theta) == (2.446, 1e-5, 50000.0)
    with pytest.raises(ValueError, match="scoring_func='softmax'"):
        arch.from_dict(dict(c, scoring_func="softmax"))
    partial = {k: v for k, v in c.items() if k != "v_head_dim"}
    with pytest.raises(ValueError, match="no v_head_dim"):
        arch.from_dict(partial)


def test_leaves_and_counts_at_the_published_widths():
    a = arch.load(CONFIG)
    mod = arch.module(a)
    held = sum(torch.Size(shape).numel() for _, shape, _ in mod.kinds(a))
    assert held == 15_960_110_208
    assert mod.latent_bytes(a, 256, 896) == 7_134_511_104
    per_head = 27 * 256 * 896 * 16 * (192 + 128) * 2
    assert per_head == 63_417_876_480
    experts = mod.decode_bytes(a, 256, 896, experts_hit=64) - mod.decode_bytes(
        a, 256, 896, experts_hit=0)
    assert experts == 28_789_702_656
    assert mod.decode_bytes(a, 256, 896) == mod.decode_bytes(a, 256, 896, experts_hit=64)
    assert mod.decode_flops(a, 1, 1) == 5_159_147_520
    # the prefill charges the expanded attention: per head and pair, 2 x (192 + 128)
    assert mod.causal_attn_flops(a, 2) - 2 * mod.causal_attn_flops(a, 1) == 27 * 16 * 2 * 320
    assert mod.train_flops(a, 2, 5) == 3 * 2 * (mod.prefill_flops(a, 1, 5) + 2 * 2048 * 163840 * 4)
    assert counts.least_seconds(0, mod.latent_bytes(a, 256, 896)) == pytest.approx(2.1297e-3, 1e-4)


def test_the_program_model_holds_every_leaf():
    """The port's model at the published widths on the meta device: every
    leaf of the draw has its parameter, of the leaf's shape, and the model
    holds nothing else; the config counts the parameters held."""
    from repro_torch.models.model import Model

    a = arch.load(CONFIG)
    mod = arch.module(a)
    cfg = mod.model_config(a)
    m = Model(cfg, device="meta", param_dtype=torch.bfloat16)
    params = dict(m.named_parameters())
    shapes = {k: s for k, s, _ in mod.kinds(a)}
    names = set()
    for _, kind, i in weights.leaves(a):
        name = mod.param_name(a, kind, i)
        want = shapes[kind] if i is None else shapes[kind][1:]
        assert tuple(params[name].shape) == want, name
        names.add(name)
    assert names == set(params)
    assert params["layers.1.moe.router_bias"].dtype == torch.float32
    assert cfg.n_params() == 15_960_110_208 - 2048  # n_params leaves out the final norm
    assert cfg.n_active_params() == 15_960_110_208 - 2048 - 26 * 58 * 3 * 2048 * 1408


def test_a_tiny_serving_cell_passes_and_its_float8_control_fails():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in (2, 1):  # seed 1 traced
        rec, checks = harness.run_cell(SERVE, TINY, seed, 0.0, seed == 1, torch.device("cpu"),
                                       time.perf_counter(), control=True)
        assert harness.judge(SERVE, checks)[0], checks
        control = dict(checks, logit_gap_mean=checks["control_logit_gap_mean"],
                       route_miss_pct=checks["control_route_miss_pct"])
        assert not harness.judge(SERVE, control)[0], checks
        assert rec["arch"].arch == "mla" and checks["judged_tokens"] > 0
    got = harness.read_metrics([(m["name"], m["unit"]) for m in spec["per_layer"]], rec)
    assert {"prefill_ms.moe", "decode_roofline_pct.moe", "mfu.moe", "moe_drop_pct.moe"} <= set(got)
    assert 0 < got["decode_roofline_pct.moe"]["value"] < 100
    # the CPU's spans have no device intervals: the span metrics find nothing
    assert not {"mla_attend_ms.mla", "mla_attend_roofline_pct.mla"} & set(got)


def _unscaled(route):
    """The gates without the routed scale."""
    def r(p, xt, cfg):
        out = route(p, xt, cfg)
        return out._replace(gate_vals=out.gate_vals / cfg.routed_scale)
    return r


def _unbiased(route):
    """The choice made without the selection bias."""
    class P:
        def __init__(self, p):
            self.p = p

        def __getitem__(self, k):
            return torch.zeros_like(self.p[k]) if k == "router_bias" else self.p[k]

    return lambda p, xt, cfg: route(P(p), xt, cfg)


def _no_rope_key(decode):
    """Decode's scores without the rotary key's term."""
    def d(p, x, cfg, cache, pos):
        blind = dict(c=cache["c"], kr=torch.zeros_like(cache["kr"]))
        return decode(p, x, cfg, blind, pos)[0], cache
    return d


@pytest.mark.parametrize("name,fault", [("moe_route", _unscaled), ("moe_route", _unbiased),
                                        ("mla_decode", _no_rope_key)],
                         ids=["gates_unscaled", "bias_ignored", "decode_without_rotary_key"])
def test_a_planted_fault_fails_the_replayed_check(monkeypatch, name, fault):
    """Each fault, planted in the program, fails the cell's check on every
    seed tried: the bias by the choices missed (the replayed gap cannot see
    it), the others by the gap."""
    from repro_torch.models import layers as PL

    monkeypatch.setattr(PL, name, fault(getattr(PL, name)))
    for seed in (1, 2, 3):
        _, checks = harness.run_cell(SERVE, TINY, seed, 0.0, False, torch.device("cpu"),
                                     time.perf_counter())
        assert not harness.judge(SERVE, checks)[0], (seed, checks)


def test_the_reference_replays_given_choices():
    """Its own choices given back: the same logits, none missed; another run's
    recorded (float8's): taken in place of its own, and some missed."""
    from portbench.reference import mla

    a = arch.from_dict(TINY)
    W = dict(weights.draw(a, 3, torch.device("cpu"), torch.float32))
    toks = torch.randint(1, a.vocab_size, (3, 12), generator=torch.Generator().manual_seed(0))
    own = mla.Replay()
    want = mla.served_logits(a, W, toks, 8, replay=own)
    assert set(own.taken) == {(j, part) for j in range(a.moe_layers) for part in (0, 1)}
    assert own.taken[(0, 0)].shape == (3 * 8, a.top_k) and own.taken[(0, 1)].shape == (3 * 4, 2)
    again = mla.Replay(own.taken)
    assert torch.equal(mla.served_logits(a, W, toks, 8, replay=again), want)
    assert again.missed == 0 and again.assigned == a.moe_layers * 3 * 12 * a.top_k
    low = mla.Replay()
    mla.served_logits(a, W, toks, 8, lowp=True, replay=low)
    theirs = mla.Replay(low.taken)
    got = mla.served_logits(a, W, toks, 8, replay=theirs)
    assert 0 < theirs.missed < theirs.assigned and not torch.equal(got, want)


def _reading(attend_ms):
    step = dict(id=0, name="model.decode_step", parent=None, attrs={}, device_ms=50.0)
    attn = [dict(id=1 + 2 * i, name="block.attn", parent=0, attrs={}, device_ms=2.0)
            for i in range(2)]
    mla = [dict(id=2 + 2 * i, name="mla.attend", parent=1 + 2 * i,
                attrs=dict(rows=256, slots=800), device_ms=ms) for i, ms in enumerate(attend_ms)]
    return dict(spans=[step, *attn, *mla], counters={})


def test_the_attend_metrics_read_the_spans(monkeypatch):
    a = arch.load(CONFIG)
    rec = dict(arch=a)
    monkeypatch.setattr(spans, "reading", lambda r: _reading([0.4, 0.6]))
    ms = harness.metric("mla_attend_ms.mla").read(rec)
    assert ms == pytest.approx(1.0)
    least = 2 * 256 * 800 * 576 * 2 / counts.HBM_BYTES_PER_S
    pct = harness.metric("mla_attend_roofline_pct.mla").read(rec)
    assert pct == pytest.approx(100 * least / 1e-3)
    # a program without the spans: nothing to read
    monkeypatch.setattr(spans, "reading", lambda r: dict(spans=[], counters={}))
    assert harness.metric("mla_attend_ms.mla").read(rec) is None
    assert harness.metric("mla_attend_roofline_pct.mla").read(rec) is None


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, torch\n"
        "from portbench.reference import mla\n"
        "from portbench import arch, weights\n"
        f"a = arch.from_dict({TINY!r})\n"
        "W = dict(weights.draw(a, 1, torch.device('cpu'), torch.float32))\n"
        "before = set(sys.modules)\n"
        "out = mla.served_logits(a, W, torch.ones(2, 9, dtype=torch.long), 6)\n"
        "assert out.shape == (2, 4, 300), out.shape\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "bad = {m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'repro_torch')}\n"
        "print(sorted(bad | (new & {'repro_torch'})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
