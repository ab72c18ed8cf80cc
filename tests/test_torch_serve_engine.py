"""The port's serving engine (``repro_torch.serve.engine``) and the ``llm``
launcher, on the CPU.

Greedy generation is held against the reference's ``ServeEngine`` on the
same params (carried over by ``params_from_reference``, fp32 compute in
both); the serve-side plumbing (prompt validation, left padding) mirrors
``tests/test_serve_engine.py`` against the port's engine.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import ParallelConfig as RParallelConfig
from repro.models.model import Model as RModel
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.config import ParallelConfig
from repro_torch.models.interop import params_from_reference
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine


def small_model(arch="minicpm-2b", dtype=torch.float32, q_chunk=16):
    m = Model(smoke_config(arch), ParallelConfig(), compute_dtype=dtype,
              q_chunk=q_chunk, kv_chunk=q_chunk, device="cpu")
    return m.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ["gemma3-27b", "minicpm-2b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "mamba2-780m"])
def test_greedy_generate_equals_the_reference_and_is_deterministic(arch):
    """``tests/test_system.py:99``'s setup (batch 2, max_seq 64, prompt 24,
    6 new tokens; the smoke window 16 exercises gemma3's and
    recurrentgemma's ring caches, the recurrent states pass alignment
    unchanged)."""
    from repro.configs import smoke_config as r_smoke

    rm = RModel(r_smoke(arch), RParallelConfig(), compute_dtype=jnp.float32,
                q_chunk=16, kv_chunk=16)
    params = rm.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, rm.cfg.vocab_size, (2, 24)).astype(np.int32)
    want = RServeEngine(rm, params, batch=2, max_seq=64).generate(prompts, max_new=6)

    pm = Model(smoke_config(arch), ParallelConfig(), compute_dtype=torch.float32,
               q_chunk=16, kv_chunk=16, device="cpu")
    params_from_reference(pm, jax.tree.map(np.asarray, params))
    engine = ServeEngine(pm, batch=2, max_seq=64, device="cpu")
    a = engine.generate(prompts, max_new=6)
    b = engine.generate(prompts, max_new=6)
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32 and a.shape == (2, 6)


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
def test_generate_with_frames_or_patches_equals_the_reference(arch):
    """``generate(..., extra_batch=)``, the reference's entry for the
    encoder-decoder and VLM archs: encoder frames or image patches drawn
    from a seed with numpy (internvl2's 8 patch positions lead the caches
    and offset decode); the same greedy tokens as the reference's engine,
    twice."""
    from repro.configs import smoke_config as r_smoke

    rm = RModel(r_smoke(arch), RParallelConfig(), compute_dtype=jnp.float32,
                q_chunk=16, kv_chunk=16)
    params = rm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, rm.cfg.vocab_size, (2, 24)).astype(np.int32)
    cfg = rm.cfg
    name, rows = ("frames", cfg.enc_seq) if cfg.is_encoder_decoder else ("patches", cfg.n_patches)
    extra = {name: rng.standard_normal((2, rows, cfg.d_model)).astype(np.float32)}
    want = RServeEngine(rm, params, batch=2, max_seq=64).generate(
        prompts, max_new=6, extra_batch={name: jnp.asarray(extra[name])})

    pm = Model(smoke_config(arch), ParallelConfig(), compute_dtype=torch.float32,
               q_chunk=16, kv_chunk=16, device="cpu")
    params_from_reference(pm, jax.tree.map(np.asarray, params))
    engine = ServeEngine(pm, batch=2, max_seq=64, device="cpu")
    a = engine.generate(prompts, max_new=6, extra_batch=extra)
    b = engine.generate(prompts, max_new=6, extra_batch={name: torch.as_tensor(extra[name])})
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,name", [("whisper-tiny", "frames"), ("internvl2-2b", "patches")])
def test_serve_without_frames_or_patches_is_refused(arch, name):
    """``serve()`` (and so ``llm``) passes prompts only, as the
    reference's, whose prefill then fails with ``KeyError``; the port
    refuses up front with a `ValueError` naming the input, and
    ``generate`` without ``extra_batch`` does too."""
    eng = ServeEngine(small_model(arch), batch=2, max_seq=32, device="cpu")
    calls = []
    eng.model.prefill = lambda *a: calls.append(a)
    reqs = [Request(uid=0, prompt=np.array([1, 2, 3], np.int32), max_new=2)]
    with pytest.raises(ValueError, match=f"reads {name} besides the prompts"):
        eng.serve(reqs, prompt_pad=8)
    assert calls == []
    del eng.model.prefill
    with pytest.raises(ValueError, match=name):
        eng.generate(np.ones((2, 8), np.int32), max_new=2)
    with pytest.raises(ValueError, match=name):
        serve_cli.main(["llm", "--device", "cpu", "--preset", "smoke", "--arch", arch])


def test_sampling_draws_from_the_seeded_generator():
    """temperature > 0: the same seed gives the same tokens, never a
    padded vocab row."""
    import dataclasses

    cfg = dataclasses.replace(smoke_config("minicpm-2b"), vocab_size=500,
                              vocab_pad_multiple=128)
    m = Model(cfg, ParallelConfig(), compute_dtype=torch.float32, device="cpu")
    m.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, 500, (2, 8)).astype(np.int32)
    runs = [ServeEngine(m, batch=2, max_seq=40, temperature=5.0, seed=s,
                        device="cpu").generate(prompts, max_new=32) for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert all((r >= 0).all() and (r < 500).all() for r in runs)


def _engine(batch=2):
    return ServeEngine(small_model(), batch=batch, max_seq=32, device="cpu")


def test_serve_rejects_overlong_prompt():
    eng = _engine()
    reqs = [Request(uid=7, prompt=np.arange(9, dtype=np.int32) + 1)]
    with pytest.raises(ValueError, match=r"uid=7.*length 9.*prompt_pad=8"):
        eng.serve(reqs, prompt_pad=8)


def test_serve_rejects_empty_prompt():
    eng = _engine()
    reqs = [Request(uid=3, prompt=np.zeros(0, np.int32))]
    with pytest.raises(ValueError, match=r"uid=3.*length 0"):
        eng.serve(reqs, prompt_pad=8)


def test_serve_left_pads_including_exact_fit():
    """Prompts shorter than and exactly equal to prompt_pad both land
    left-aligned-to-the-right, padded with token 0."""
    eng = _engine(batch=2)
    captured = []

    def fake_generate(prompts, max_new):
        captured.append(np.array(prompts))
        return np.zeros((eng.batch, max_new), np.int32)

    eng.generate = fake_generate
    reqs = [
        Request(uid=0, prompt=np.array([1, 2, 3], np.int32), max_new=4),
        Request(uid=1, prompt=np.arange(1, 9, dtype=np.int32), max_new=4),
    ]
    done = eng.serve(reqs, prompt_pad=8)
    assert [r.uid for r in done] == [0, 1] and all(r.done for r in done)
    (prompts,) = captured
    np.testing.assert_array_equal(prompts[0], np.array([0, 0, 0, 0, 0, 1, 2, 3], np.int32))
    np.testing.assert_array_equal(prompts[1], np.arange(1, 9, dtype=np.int32))


def test_serve_validates_before_any_wave_runs():
    eng = _engine(batch=1)
    calls = []
    eng.generate = lambda *a, **k: calls.append(a) or np.zeros((1, 1), np.int32)
    reqs = [
        Request(uid=0, prompt=np.array([1], np.int32), max_new=1),
        Request(uid=1, prompt=np.arange(99, dtype=np.int32), max_new=1),
    ]
    with pytest.raises(ValueError, match="uid=1"):
        eng.serve(reqs, prompt_pad=8)
    assert calls == []


def test_serve_runs_two_waves_end_to_end():
    """Two waves of real prefill + decode; short prompts are left-padded
    and each request gets its own ``max_new`` tokens."""
    eng = ServeEngine(small_model("gemma3-27b"), batch=2, max_seq=24, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, 4 + 5 * i).astype(np.int32),
                    max_new=3 + i) for i in range(3)]
    done = eng.serve(reqs, prompt_pad=16)
    assert [len(r.out_tokens) for r in done] == [3, 4, 5]
    assert all(0 <= t < 512 for r in done for t in r.out_tokens)


@pytest.mark.parametrize("argv", [
    ["llm", "--device", "cpu", "--preset", "smoke"],
    ["--device", "cpu", "--requests", "2", "--max-new", "3"],
])
def test_llm_cli_runs_on_the_cpu(argv):
    """``llm`` runs; a bare command line routes to ``llm``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_cli.main(argv)
    first = out.getvalue().splitlines()[0]
    n_req, n_new = (8, 16) if argv[0] == "llm" else (2, 3)
    assert first.startswith(f"served {n_req} requests, {n_req * n_new} tokens in ")
    assert first.endswith("tok/s on CPU)")


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen1.5-4b", "gemma3-27b",
                                  "deepseek-coder-33b", "deepseek-moe-16b",
                                  "moonshot-v1-16b-a3b", "mamba2-780m", "recurrentgemma-9b"])
def test_llm_cli_serves_every_ported_arch(arch):
    """``llm --device cpu --preset smoke --arch <arch>`` for each of the
    eight decoder-only archs; every token in the vocab."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_cli.main(["llm", "--device", "cpu", "--preset", "smoke", "--arch", arch,
                        "--requests", "2", "--max-new", "3"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("served 2 requests, 6 tokens in ")
    toks = [int(t) for line in lines[1:] for t in line.split("[")[1].split("]")[0].split(",")]
    assert len(toks) == 6 and all(0 <= t < smoke_config(arch).vocab_size for t in toks)
