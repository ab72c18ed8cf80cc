"""The plain reference (`portbench.reference`) against the port at a tiny
size on the CPU, both in float32: prefill then decode logits through the
port's engine, the MoE with capacity drops, and training steps."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import arch, port, traffic, weights
from portbench.drivers import serve as serve_driver
from portbench.reference import decoder, train as ref_train
from portbench.tests import tiny

CPU = torch.device("cpu")


def _fp32_model(a, seed, tok_scale=1.0, chunk=8):
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.model import Model

    m = Model(port.model_config(a), ParallelConfig(), compute_dtype=torch.float32,
              q_chunk=chunk, kv_chunk=chunk, device=CPU, param_dtype=torch.float32)
    port.load(m, a, seed, torch.float32, tok_scale)
    return m


def _served(a, seed, n=4, pad=12, max_new=6):
    """The port's engine over one wave: (padded prompts, tokens, logits of each step)."""
    from repro_torch.serve.engine import ServeEngine

    model = _fp32_model(a, seed)
    logits = []
    pre, dec = model.prefill, model.decode_step

    def rec_prefill(batch):
        out = pre(batch)
        logits.append(out[0].clone())
        return out

    def rec_decode(caches, tok, pos):
        out = dec(caches, tok, pos)
        logits.append(out[0].clone())
        return out

    model.prefill, model.decode_step = rec_prefill, rec_decode
    eng = ServeEngine(model, batch=n, max_seq=pad + max_new, device="cpu")
    rng = np.random.default_rng(seed)
    prompts = np.stack([serve_driver.padded(rng.integers(1, a.vocab_size, size=int(k)), pad)
                        for k in rng.integers(3, pad + 1, size=n)])
    out = eng.generate(prompts, max_new)
    return prompts, out, torch.stack(logits, 1)[..., : a.vocab_size]


@pytest.mark.parametrize("config", [tiny.DENSE, tiny.MOE, tiny.MOE_UNTIED],
                         ids=["dense", "moe", "moe-untied"])
def test_served_logits_match_port(config):
    a = arch.from_dict(config)
    prompts, out, port_logits = _served(a, seed=3)
    W = dict(weights.draw(a, 3, CPU, torch.float32))
    toks = torch.as_tensor(np.concatenate([prompts, out[:, :-1]], 1))
    got = decoder.served_logits(a, W, toks, prompts.shape[1])
    torch.testing.assert_close(got, port_logits.float(), rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops_match_port():
    """A tight capacity drops assignments; the reference keeps the same ones."""
    from repro_torch.models import layers as PL

    a = dataclasses.replace(arch.from_dict(tiny.MOE), capacity_factor=0.5)
    W = dict(weights.draw(a, 5, CPU, torch.float32))
    p = {k: W[k][0] for k in ("router", "we_gate", "we_up", "we_down",
                              "ws_gate", "ws_up", "ws_down")}
    x = torch.randn(2, 16, a.d_model, generator=torch.Generator().manual_seed(0))
    want, _ = PL.moe_ffn(p, x, port.model_config(a))
    expert, _ = decoder.route(a, W["router"][0], x.reshape(-1, a.d_model), False)
    assert not bool(decoder.kept(a, expert, 1).all()), "the capacity drops nothing"
    got = decoder.moe_ffn(a, W, 0, x, prompt_len=16, lowp=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_moe_decode_groups_are_per_position():
    """Positions after the prompt route as groups of the batch: a decode
    step's capacity, not the prompt's."""
    a = dataclasses.replace(arch.from_dict(tiny.MOE), capacity_factor=0.25)
    W = dict(weights.draw(a, 6, CPU, torch.float32))
    x = torch.randn(8, 6, a.d_model, generator=torch.Generator().manual_seed(1))
    whole = decoder.moe_ffn(a, W, 0, x, prompt_len=4, lowp=False)
    for t in (4, 5):
        alone = decoder.moe_ffn(a, W, 0, x[:, t:t + 1], prompt_len=1, lowp=False)
        torch.testing.assert_close(whole[:, t:t + 1], alone, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(whole[:, :4], decoder.moe_ffn(a, W, 0, x[:, :4], 4, False),
                               rtol=1e-5, atol=1e-6)


def test_train_steps_match_port():
    """Two AdamW steps of the port's `make_train_step` (float32 compute) and
    of the reference: the losses and every parameter after them."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, wsd_schedule
    from repro_torch.train.steps import make_train_step

    a = arch.from_dict(tiny.DENSE)
    tr = tiny.TRAIN["traffic"]
    opt = tiny.TRAIN["program"]["adamw"]
    sched = (1e-3, 0, 10**6, 1)
    model = _fp32_model(a, 9)
    params = model.train_params()
    cfg = AdamWConfig(**opt)
    state = adamw_init(params, cfg)
    step = make_train_step(model, wsd_schedule(*sched), cfg)
    W = {k: t.requires_grad_(True) for k, t in weights.draw(a, 9, CPU, torch.float32)}
    ropt = ref_train.AdamW(W, **opt)
    for i in range(2):
        raw = torch.as_tensor(traffic.train_batch(tr, a.vocab_size, 9, i).astype(np.int64))
        batch = dict(tokens=raw[:, :-1], labels=raw[:, 1:], mask=torch.ones(raw[:, 1:].shape))
        params, state, metrics = step(params, state, batch)
        loss = ref_train.loss_and_grads(a, W, raw[:, :-1], raw[:, 1:])
        ropt.update(W, ref_train.wsd_lr(i, *sched))
        assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-5)
    for key, kind, i in weights.leaves(a):
        want = W[kind] if i is None else W[kind][i]
        got = model.get_parameter(port.param_name(a, kind, i))
        torch.testing.assert_close(got.detach(), want.detach(), rtol=1e-4, atol=1e-6)
