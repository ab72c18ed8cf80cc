"""The check that decides ``correct``, driven through the harness at a tiny
size on the CPU (the look for a card skipped): sound runs pass; the float8
control put in the program's place fails; and so does the timed path
broken underneath, once for each fault the cell can have."""

import time

import pytest
import torch

from portbench import arch, harness
from portbench.drivers import train as train_driver
from portbench.tests import tiny

CPU = torch.device("cpu")
SEEDS = [1, 2, 3]


def _run(cell, config, seed, **extra):
    rec, checks = harness.run_cell(cell, config, seed, 0.0, False, CPU, time.perf_counter(),
                                   **extra)
    return rec, checks, harness.judge(cell, checks)[0]


def altered_token(objs):
    """A token altered where it is produced: row 0's sampled token + 1."""
    eng = objs["engine"]
    sample = eng._sample

    def s(logits):
        t = sample(logits).clone()
        t[0] = (t[0] + 1) % logits.shape[-1]
        return t

    eng._sample = s


def unchanged_cache(objs):
    """A decode step that returns its state (the KV cache) unchanged."""
    model = objs["model"]
    step = model.decode_step

    def d(caches, tok, pos):
        logits, _ = step([{k: v.clone() for k, v in c.items()} for c in caches], tok, pos)
        return logits, caches

    model.decode_step = d


def half_batch(objs):
    """Half of the batch left out, the mean taken over the rest."""
    step = objs["step_fn"]
    return lambda p, o, b: step(p, o, {k: v[: v.shape[0] // 2] for k, v in b.items()})


def unchanged_state(objs):
    """A train step that returns its state unchanged (the loss still read)."""
    model = objs["model"]

    def step(params, opt_state, batch):
        loss, _ = model.loss_fn(batch, params=params)
        return params, opt_state, dict(loss=loss.detach())

    return step


SERVE_CELLS = [(tiny.DENSE, tiny.SERVE), (tiny.MOE, tiny.SERVE_MOE)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config,cell", SERVE_CELLS, ids=["dense", "moe"])
def test_serve_sound_passes_and_control_fails(config, cell, seed):
    rec, checks, ok = _run(cell, config, seed, control=True)
    assert ok, checks
    assert rec["attempted"] >= cell["traffic"]["clients"]
    control = dict(checks, logit_gap=checks["control_logit_gap"],
                   logit_gap_mean=checks["control_logit_gap_mean"])
    assert not harness.judge(cell, control)[0], checks


@pytest.mark.parametrize("fault", [altered_token, unchanged_cache])
@pytest.mark.parametrize("config,cell", SERVE_CELLS, ids=["dense", "moe"])
def test_serve_faults_fail(config, cell, fault):
    _, checks, ok = _run(cell, config, 1, fault=fault)
    assert not ok, checks


@pytest.mark.parametrize("seed", SEEDS)
def test_train_sound_passes_and_control_fails(seed):
    _, checks, ok = _run(tiny.TRAIN, tiny.DENSE, seed)
    assert ok, checks
    ctx = dict(arch=arch.from_dict(tiny.DENSE), cell=tiny.TRAIN, seed=seed, device=CPU)
    control = train_driver.check(ctx, train_driver.follow(ctx, lowp=True))
    assert not harness.judge(tiny.TRAIN, control)[0], control


@pytest.mark.parametrize("fault", [half_batch, unchanged_state])
def test_train_faults_fail(fault):
    _, checks, ok = _run(tiny.TRAIN, tiny.DENSE, 1, fault=fault)
    assert not ok, checks
