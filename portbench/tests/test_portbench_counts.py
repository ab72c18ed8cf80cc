"""`portbench.counts` on the tiny configurations, against numbers worked by
hand (d 64, 4 heads of 16, FFN 128, vocabulary 300, 2 layers; the MoE: 3
layers, the first dense, 8 experts of 32, top 2, one shared)."""

import pytest

from portbench import arch, counts, readers
from portbench.tests import tiny

DENSE = arch.from_dict(tiny.DENSE)
MOE = arch.from_dict(tiny.MOE)


def test_matmul_weights():
    assert counts.attn_params(DENSE) == 64 * 16 * 12 + 4 * 16 * 64 == 16384
    assert counts.token_matmul_params(DENSE) == 2 * (16384 + 3 * 64 * 128) == 81920
    # an MoE token passes its router, its 2 routed experts and the shared one
    assert counts.ffn_params_active(MOE, 1) == 64 * 8 + 3 * 64 * 32 * 3 == 18944
    assert counts.token_matmul_params(MOE) == 3 * 16384 + 24576 + 2 * 18944 == 111616


def test_causal_attention_counts_attended_positions_only():
    # position p attends p + 1 positions: 1 + ... + 5 = 15 of the 25 a square computes
    assert counts.causal_attn_flops(DENSE, 5) == 2 * 4 * 4 * 16 * 15 == 7680
    assert counts.attn_flops(DENSE, 10) == 2 * 4 * 4 * 16 * 10 == 5120


def test_step_operations():
    assert counts.decode_flops(DENSE, 3, 10) == 3 * (2 * 81920 + 5120 + 2 * 64 * 300) == 622080
    assert counts.prefill_flops(DENSE, 2, 5) == 2 * (2 * 81920 * 5 + 7680 + 2 * 64 * 300)
    # forward and backward: 3 x (2 x (weights + unembedding) x tokens + causal attention)
    causal4 = 2 * 4 * 4 * 16 * 10
    assert counts.train_flops(DENSE, 1, 4) == 3 * (2 * (81920 + 64 * 300) * 4 + causal4) == 2442240


def test_decode_bytes_attended_positions_only():
    weights = 2 * (16384 + 2 * 64) + 64 + 2 * 3 * 64 * 128 + 64 * 300  # 101440
    kv_row = 2 * 2 * 4 * 16 * 2  # one position's keys and values over the layers, bf16
    want = weights * 2 + 3 * 64 * 2 + 3 * 10 * kv_row + 3 * kv_row + 3 * 300 * 2
    assert counts.decode_bytes(DENSE, 3, 10) == want == 221960
    assert counts.decode_bytes(DENSE, 3, 11) - counts.decode_bytes(DENSE, 3, 10) == 3 * kv_row


def test_decode_bytes_routed_experts_only():
    # 2 MoE layers; 3 experts fewer reached means 3 x 3 x 64 x 32 weights fewer a layer
    every = counts.decode_bytes(MOE, 3, 10)
    assert every - counts.decode_bytes(MOE, 3, 10, experts_hit=5) == 2 * 3 * 3 * 64 * 32 * 2


def test_least_time_is_the_larger_bound():
    assert counts.least_seconds(989e12, 0) == 1.0
    assert counts.least_seconds(0, 3.35e12) == 1.0
    assert counts.least_seconds(989e12, 2 * 3.35e12) == 2.0


def test_serve_window_counts_unpadded_prompts_and_live_slots():
    """Two requests of 5 and 2 prompt tokens, 3 and 1 output tokens: both
    prompts unpadded, and two decode tokens of the first at 6 and 7
    positions; the second's slot, finished, is not counted."""
    rec = dict(arch=DENSE, window_s=1.0,
               waves=[dict(prompt_len=[5, 2], max_new=[3, 1], decode_steps=2)])
    prefill5 = 2 * 81920 * 5 + 2 * 4 * 4 * 16 * 15 + 2 * 64 * 300  # 865280
    prefill2 = 2 * 81920 * 2 + 2 * 4 * 4 * 16 * 3 + 2 * 64 * 300  # 367616
    decode = lambda n: 2 * 81920 + 2 * 4 * 4 * 16 * n + 2 * 64 * 300  # noqa: E731
    assert readers.serve_window_flops(rec) == prefill5 + prefill2 + decode(6) + decode(7) == 1644032


def test_decode_roofline_counts_live_slots_at_their_positions():
    # 3 live slots attending 10 positions each: bytes-bound, 221,960 B in 1 ms
    rec = dict(arch=DENSE, decode_spans=[dict(ms=1.0, live=3, attended=10.0)])
    assert readers.decode_roofline_pct(rec) == pytest.approx(100 * 221960 / 3.35e12 / 1e-3)
    assert readers.decode_roofline_pct(dict(arch=DENSE, decode_spans=[])) is None
