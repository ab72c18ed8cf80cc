"""Tiny configurations and cells of the benchmark's CPU tests.

The limits are set from readings at this size on seeds 1-4 (CPU, torch
2.13): sound runs read a logit gap of at most 0.00026 and the float8
control at least 0.0017 (the MoE's mean gap: 0 and at least 3.3e-4); in training sound runs read loss, gradient and
change gaps of at most 2.7e-4, 1.9e-3 and 5.3e-4, the control at least
1.1e-3, 1.07e-2 and 3.7e-3."""

from __future__ import annotations

import copy

DENSE = dict(
    name="tiny-dense", hidden_size=64, intermediate_size=128, num_attention_heads=4,
    num_key_value_heads=4, num_hidden_layers=2, vocab_size=300, hidden_act="silu",
    rope_theta=10000.0, tie_word_embeddings=True, rms_norm_eps=1e-6, head_dim=16,
    vocab_pad_multiple=64)

MOE = dict(DENSE, name="tiny-moe", num_hidden_layers=3, n_routed_experts=8, n_shared_experts=1,
           num_experts_per_tok=2, moe_intermediate_size=32, first_k_dense_replace=1,
           norm_topk_prob=True, capacity_factor=1.25)

#: the MoE with its own unembedding, as deepseek-moe-16b runs
MOE_UNTIED = dict(MOE, name="tiny-moe-untied", tie_word_embeddings=False)

SERVE = dict(
    name="tiny.serve", config="tiny", driver="serve", chips=1,
    traffic=dict(kind="closed_waves", clients=4,
                 prompt_len=dict(dist="log_uniform", lo=4, hi=16),
                 max_new=dict(dist="uniform", lo=3, hi=8), prompt_pad=16, max_seq=40),
    weights=dict(tok_scale=0.02),
    check=dict(sample=4, limits=dict(logit_gap=0.001)))

#: the MoE cell compares the mean gap (its widest has no upper reading, PERF.md §4)
SERVE_MOE = dict(SERVE, name="tiny-moe.serve", check=dict(limits=dict(logit_gap_mean=1e-4)))

TRAIN = dict(
    name="tiny.train", config="tiny", driver="train", chips=1,
    traffic=dict(kind="synthetic_lm", batch=2, seq=32, zipf_a=1.2),
    program=dict(schedule=dict(kind="wsd", peak_lr=3e-4, warmup=3, stable=1000000, decay=1),
                 adamw=dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)),
    check=dict(limits=dict(loss_gap=5e-4, grad_gap=5e-3, update_gap=1.5e-3)))


def cell(base: dict, **limits) -> dict:
    c = copy.deepcopy(base)
    c["check"]["limits"].update(limits)
    return c
