"""The port's training path (``repro_torch.models.model.Model.loss_fn``,
``optim.adamw``, ``data.pipeline``, ``train.steps``, ``launch.train``)
against the reference's, on the CPU at smoke size.

Params come from the reference's ``Model.init`` and cross over through
``params_from_reference``; tokens, masks, frames, patches, grads and
optimizer states are drawn from seeds with numpy.  Compute is fp32 in
both packages.  Tolerances:

  * ``loss_fn``: the loss within ``1e-5`` absolute (measured gap 0 to
    5e-7 at a loss of about 6.3), every grad leaf within ``1e-3`` of the
    reference leaf's own scale (max |g|; measured up to 1.5e-4, mamba2's
    embedding);
  * ``adamw_update`` on identical inputs: params, moments and the
    error-feedback residual within ``rtol=1e-6, atol=1e-7``, the step
    equal;
  * schedules: ``rtol=1e-6``; the data pipeline: bit-equal;
  * train steps through AdamW run with ``b1=0`` and no clipping where
    grads are compared, so that the first moment after one step IS the
    (accumulated) grad and no ``lr * sign(g)`` of a near-zero grad hides
    or fakes a difference: grad_accum=2 against one batch within
    ``1e-5`` of each leaf's scale; ``cast_bf16`` against the reference's
    within ``2**-7`` of scale (one bf16 ulp), every grad bf16-exact.
"""

import contextlib
import io
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import ParallelConfig as RParallelConfig
from repro.models.model import Model as RModel
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models.config import ParallelConfig
from repro_torch.models.interop import params_from_reference
from repro_torch.models.model import Model
from repro_torch.optim import adamw as A
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.steps import make_eval_step, make_train_step

ARCHS = ("minicpm-2b", "qwen1.5-4b", "gemma3-27b", "deepseek-coder-33b", "deepseek-moe-16b",
         "moonshot-v1-16b-a3b", "mamba2-780m", "recurrentgemma-9b", "whisper-tiny",
         "internvl2-2b")
LOSS_ATOL, GRAD_REL = 1e-5, 1e-3


def models(arch, q_chunk=8):
    """The reference's model and params, and the port's model on them."""
    from repro.configs import smoke_config as r_smoke

    rm = RModel(r_smoke(arch), RParallelConfig(), compute_dtype=jnp.float32,
                q_chunk=q_chunk, kv_chunk=q_chunk)
    params = rm.init(jax.random.PRNGKey(0))
    pm = Model(smoke_config(arch), ParallelConfig(), compute_dtype=torch.float32,
               q_chunk=q_chunk, kv_chunk=q_chunk, device="cpu")
    return rm, params, params_from_reference(pm, jax.tree.map(np.asarray, params))


def np_batch(cfg, b=2, s=16, seed=0, masked=True) -> dict:
    """tokens / labels / mask (a fifth of the positions masked out), and
    the frames or patches the config reads."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = dict(tokens=toks[:, :-1], labels=toks[:, 1:],
               mask=(rng.random((b, s)) > 0.2 if masked else np.ones((b, s))).astype(np.float32))
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        out["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def jbatch(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def tbatch(nb):
    return {k: torch.tensor(v) for k, v in nb.items()}  # copies: updates run in place


def flat_ref(tree) -> dict:
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def same_leaves(got_tree, want_tree, rel, what):
    want = flat_ref(want_tree)
    got = dict(L.tree_leaves(got_tree))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path].detach().float().numpy()
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rel * scale + 1e-30, (what, path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_equal_the_reference(arch):
    """``loss_fn`` (chunked CE over two chunks, a partial mask, the MoE
    aux loss, remat "block" on the scanned groups) and every grad leaf,
    against ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    rm, params, pm = models(arch)
    nb = np_batch(pm.cfg)
    (r_loss, r_aux), r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: rm.loss_fn(p, b, ce_chunk=8), has_aux=True))(params, jbatch(nb))

    P = pm.train_params()
    loss, aux = pm.loss_fn(tbatch(nb), ce_chunk=8)
    grads = torch.autograd.grad(loss, list(P.values()))
    assert abs(float(loss.detach()) - float(r_loss)) <= LOSS_ATOL
    np.testing.assert_allclose(float(aux["ntokens"]), float(r_aux["ntokens"]))
    np.testing.assert_allclose(float(aux["aux"].detach()), float(r_aux["aux"]), rtol=1e-5, atol=1e-7)
    same_leaves(pm.to_tree(dict(zip(P, grads))), r_grads, GRAD_REL, arch)


def random_tree(rng, shapes) -> dict:
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"a": (8, 16), "b": (16,), "c": (3, 4, 5)}


@pytest.mark.parametrize("compression,clip_norm", [
    ("none", 1.0), ("none", 0.0), ("none", 1e3), ("bf16", 1.0), ("int8_ef", 1.0)])
def test_adamw_update_equals_the_reference(compression, clip_norm):
    """One update on identical params, grads and a non-zero state (step
    3): clipping active (norm 1.0 against grads of norm about 8), off
    (0.0) and inactive (1e3); bf16 and int8 with error feedback."""
    from repro.optim import adamw as RA

    rng = np.random.default_rng(0)
    params, grads = random_tree(rng, SHAPES), random_tree(rng, SHAPES)
    m = random_tree(rng, SHAPES)
    v = {k: np.abs(x) for k, x in random_tree(rng, SHAPES).items()}
    ef = {k: 0.01 * x for k, x in random_tree(rng, SHAPES).items()}
    step = np.int32(3)
    kw = dict(compression=compression, clip_norm=clip_norm)
    r_state = dict(step=jnp.asarray(step), m=jbatch(m), v=jbatch(v))
    state = dict(step=torch.tensor(step), m=tbatch(m), v=tbatch(v))
    if compression == "int8_ef":
        r_state["ef"], state["ef"] = jbatch(ef), tbatch(ef)
    r_p, r_s = RA.adamw_update(jbatch(grads), r_state, jbatch(params), jnp.float32(3e-3),
                               RA.AdamWConfig(**kw))
    p, s = A.adamw_update(tbatch(grads), state, tbatch(params), torch.tensor(3e-3),
                          A.AdamWConfig(**kw))
    assert int(s["step"]) == int(r_s["step"]) == 4 and s["step"].dtype == torch.int32
    for got, want in [(p, r_p), (s["m"], r_s["m"]), (s["v"], r_s["v"])] + (
            [(s["ef"], r_s["ef"])] if compression == "int8_ef" else []):
        for k in SHAPES:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    assert not np.allclose(p["a"].numpy(), params["a"])
    np.testing.assert_allclose(float(A.global_norm(tbatch(grads))),
                               float(RA.global_norm(jbatch(grads))), rtol=1e-6)


def test_adamw_init_and_a_nested_tree_carry_the_reference_state():
    """``adamw_init`` gives the reference's ``{step, m, v[, ef]}`` (int32
    step, fp32 zeros shaped like params) on a nested tree as on a flat
    dict."""
    from repro.optim import adamw as RA

    rng = np.random.default_rng(1)
    tree = {"x": random_tree(rng, SHAPES), "y": {"z": rng.standard_normal(4).astype(np.float32)}}
    cfg = A.AdamWConfig(compression="int8_ef")
    got = A.adamw_init(_map_np(torch.as_tensor, tree), cfg)
    want = RA.adamw_init(_map_np(jnp.asarray, tree), RA.AdamWConfig(compression="int8_ef"))
    assert sorted(got) == sorted(want) == ["ef", "m", "step", "v"]
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    assert got["m"]["y"]["z"].shape == (4,) and float(got["v"]["x"]["c"].abs().max()) == 0


def _map_np(fn, tree):
    return {k: _map_np(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["wsd", "cosine", "const"])
def test_schedules_equal_the_reference(name):
    """Each schedule at steps 0..40 as the launcher builds it for 30 steps
    (warmup 3, stable 24, decay 3: the decay stage and beyond included),
    from an int32 step tensor as the train step passes it."""
    from repro.optim import adamw as RA

    def build(mod):
        return dict(wsd=mod.wsd_schedule(3e-4, 3, 24, 3),
                    cosine=mod.cosine_schedule(3e-4, 3, 30),
                    const=mod.constant_schedule(3e-4))[name]

    r_f, f = build(RA), build(A)
    for step in range(41):
        got = f(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(r_f(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("source", ["synthetic", "memmap"])
def test_pipeline_batches_are_bit_equal(source, tmp_path):
    """``Pipeline.get_batch`` for several (seed, step, host, n_hosts):
    tokens, labels and mask bit-equal to the reference's."""
    from repro.data import pipeline as RP

    path = None
    if source == "memmap":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(0).integers(-5, 600, 4000).astype(np.int32).tofile(path)
    for seed, step, host, n_hosts in [(0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 4), (5, 11, 3, 4)]:
        cfg = dict(batch_per_host=3, seq_len=17, vocab_size=512, seed=seed, path=path)
        got = Pipeline(DataConfig(**cfg), host, n_hosts).get_batch(step)
        want = RP.Pipeline(RP.DataConfig(**cfg), host, n_hosts).get_batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def grads_of_one_step(model, nb, **kw) -> tuple[dict, dict]:
    """One train step with ``b1=0`` and no clipping: the first moment is
    then exactly the step's grad.  Returns (grads as the reference's tree,
    metrics)."""
    P = model.train_params()
    cfg = A.AdamWConfig(b1=0.0, clip_norm=0.0)
    step = make_train_step(model, A.constant_schedule(1e-3), cfg, **kw)
    _, state, metrics = step(P, A.adamw_init(P, cfg), tbatch(nb))
    return model.to_tree(state["m"]), metrics


def test_grad_accum_two_equals_one_batch():
    """Two microbatches of 2 rows (grads accumulated in fp32, each / 2)
    against one batch of 4: the loss, grad norm and every grad leaf."""
    cfg = smoke_config("minicpm-2b")
    nb = np_batch(cfg, b=4, masked=False)
    fresh = lambda: Model(cfg, ParallelConfig(), compute_dtype=torch.float32, q_chunk=8,
                          kv_chunk=8, device="cpu").init(torch.Generator().manual_seed(0))
    one, m1 = grads_of_one_step(fresh(), nb)
    two, m2 = grads_of_one_step(fresh(), nb, grad_accum=2)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    assert int(m1["step"]) == int(m2["step"]) == 1
    for path, g in L.tree_leaves(one):
        scale = float(g.abs().max())
        assert float((dict(L.tree_leaves(two))[path] - g).abs().max()) <= 1e-5 * scale, path


def test_cast_bf16_grads_reach_the_fp32_masters():
    """``cast_bf16``: the forward reads bf16 casts of the fp32 masters and
    the grads flow back through the cast (so every grad is a bf16 value
    in fp32), against the reference's ``cast_bf16`` step; the masters
    stay fp32 and move."""
    from repro.optim import adamw as RA
    from repro.train.steps import make_train_step as r_make

    rm, params, pm = models("qwen1.5-4b")
    nb = np_batch(pm.cfg, masked=False)
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    grads, metrics = grads_of_one_step(pm, nb, cast_bf16=True)
    r_cfg = RA.AdamWConfig(b1=0.0, clip_norm=0.0)
    _, r_state, r_metrics = jax.jit(r_make(rm, RA.constant_schedule(1e-3), r_cfg,
                                           cast_bf16=True))(
        params, RA.adamw_init(params, r_cfg), jbatch(nb))
    np.testing.assert_allclose(float(metrics["loss"]), float(r_metrics["loss"]), rtol=1e-5)
    same_leaves(grads, r_state["m"], 2.0**-7, "cast_bf16 grads")
    for _, g in L.tree_leaves(grads):
        assert torch.equal(g, g.to(torch.bfloat16).float())
    moved = [n for n, p in pm.named_parameters()
             if p.dtype == torch.float32 and not torch.equal(p.detach(), before[n])]
    assert len(moved) == len(before)


def test_eval_step_and_grad_shardings():
    cfg = smoke_config("minicpm-2b")
    m = Model(cfg, ParallelConfig(), compute_dtype=torch.float32, device="cpu")
    m.init(torch.Generator().manual_seed(0))
    nb = tbatch(np_batch(cfg))
    got = make_eval_step(m)(dict(m.named_parameters()), nb)["loss"]
    with torch.no_grad():
        want, _ = m.loss_fn(nb)
    assert float(got) == float(want) and not got.requires_grad
    with pytest.raises(ValueError, match="grad_shardings"):
        make_train_step(m, A.constant_schedule(1e-3), A.AdamWConfig(), grad_shardings={})


def test_train_checkpoint_resume_serve(tmp_path):
    """``tests/test_system.py::test_train_checkpoint_resume_serve`` on the
    port: 8 steps with a falling loss, save (the reference's layout),
    restore into a fresh model and state, continue one step, serve."""
    cfg = smoke_config("qwen1.5-4b")
    model = Model(cfg, ParallelConfig(), q_chunk=16, kv_chunk=16, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    params = model.train_params()
    opt_cfg = A.AdamWConfig()
    opt = A.adamw_init(params, opt_cfg)
    data = Pipeline(DataConfig(batch_per_host=4, seq_len=32, vocab_size=cfg.vocab_size, seed=0))
    step = make_train_step(model, A.constant_schedule(3e-3), opt_cfg)

    losses = []
    for s in range(8):
        batch = {k: torch.as_tensor(v) for k, v in data.get_batch(s).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # tiny model on zipf data learns marginals

    mgr = CheckpointManager(str(tmp_path), async_save=False)
    saved = dict(p=model.to_tree(params), o=dict(step=opt["step"], m=model.to_tree(opt["m"]),
                                                  v=model.to_tree(opt["v"])))
    mgr.save(8, saved)

    # "crash" -> restore into fresh trees and continue one step
    model2 = Model(cfg, ParallelConfig(), q_chunk=16, kv_chunk=16, device="cpu")
    model2.init(torch.Generator().manual_seed(1))
    like = dict(p=model2.specs(), o=dict(step=0, m=model2.specs(), v=model2.specs()))
    restored, _ = mgr.restore(like, device="cpu")
    for (path, got), (_, want) in zip(L.tree_leaves(restored), L.tree_leaves(saved)):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    model2.load_tree(restored["p"])
    p2 = model2.train_params()
    o2 = dict(step=restored["o"]["step"], m=model2.from_tree(restored["o"]["m"]),
              v=model2.from_tree(restored["o"]["v"]))
    assert int(o2["step"]) == 8
    assert all(torch.equal(p2[n], params[n]) for n in params)
    batch = {k: torch.as_tensor(v) for k, v in data.get_batch(8).items()}
    p2, o2, m2 = make_train_step(model2, A.constant_schedule(3e-3), opt_cfg)(p2, o2, batch)
    assert np.isfinite(float(m2["loss"]))

    # serve from the trained weights
    engine = ServeEngine(model2, batch=2, max_seq=48, device="cpu")
    out = engine.generate(np.ones((2, 16), np.int32), max_new=4)
    assert out.shape == (2, 4)
    assert (out >= 0).all() and (out < cfg.padded_vocab).all()


def run_cli(argv) -> tuple[dict, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_cli.main(["--device", "cpu", "--preset", "smoke", *argv])
    return out, buf.getvalue()


def test_launcher_resume_equals_the_uninterrupted_run(tmp_path):
    """8 steps straight against 4 steps with a checkpoint every 2 and a
    ``--resume`` to 8 (the wsd schedule of 4 and 8 steps agree on steps
    0-3): the final params and optimizer state bit-equal, the resumed
    losses those of the straight run.  The checkpoint is the reference's
    layout: the reference's `CheckpointManager` restores it into the
    reference's ``(params, adamw state)`` trees."""
    from repro.ckpt.manager import CheckpointManager as RCheckpointManager
    from repro.configs import smoke_config as r_smoke
    from repro.optim import adamw as RA

    ck = str(tmp_path / "ck")
    straight, _ = run_cli(["--steps", "8"])
    first, log = run_cli(["--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2"])
    assert "training complete" in log
    assert CheckpointManager(ck).steps() == [2, 4]
    resumed, log = run_cli(["--steps", "8", "--ckpt-dir", ck, "--ckpt-every", "2", "--resume"])
    assert "resumed from step 4" in log and resumed["start_step"] == 4
    assert resumed["losses"] == straight["losses"][4:]
    assert first["losses"] == straight["losses"][:4]
    for name, p in straight["params"].items():
        assert torch.equal(resumed["params"][name], p), name
    for key in ("m", "v"):
        for name, x in straight["opt_state"][key].items():
            assert torch.equal(resumed["opt_state"][key][name], x), (key, name)
    assert int(resumed["opt_state"]["step"]) == int(straight["opt_state"]["step"]) == 8

    rm = RModel(r_smoke("minicpm-2b"), RParallelConfig())
    r_params = rm.init(jax.random.PRNGKey(1))
    tree, _ = RCheckpointManager(ck).restore(
        dict(p=r_params, o=RA.adamw_init(r_params, RA.AdamWConfig())))
    model = straight["model"]
    for path, t in L.tree_leaves(model.to_tree(resumed["params"])):
        assert np.array_equal(flat_ref(tree["p"])[path], t.detach().numpy()), path
    assert int(tree["o"]["step"]) == 8


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
def test_launcher_trains_the_encoder_decoder_and_vlm(arch):
    """Zero frames / patches, as the reference's launcher feeds them."""
    out, log = run_cli(["--arch", arch, "--steps", "3"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert "training complete" in log


def test_sigterm_writes_a_final_checkpoint(tmp_path, monkeypatch):
    """SIGTERM during step 2: that step finishes, a checkpoint of step 3
    is written, and the loop ends without "training complete"; the
    previous handler is back afterwards."""
    get_batch = Pipeline.get_batch

    def interrupting(self, step):
        if step == 2:
            signal.raise_signal(signal.SIGTERM)
        return get_batch(self, step)

    monkeypatch.setattr(Pipeline, "get_batch", interrupting)
    before = signal.getsignal(signal.SIGTERM)
    out, log = run_cli(["--steps", "8", "--ckpt-dir", str(tmp_path)])
    assert "signal received" in log and "training complete" not in log
    assert len(out["losses"]) == 3 and CheckpointManager(str(tmp_path)).latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) is before
