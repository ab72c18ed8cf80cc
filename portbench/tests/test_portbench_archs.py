"""Architectures as modules (`arch`, ``archs/<name>.py``), on the CPU.

A stand-in architecture (``standin/``: the decoder with q, k and v biases)
enters a copy of the benchmark as a later PR would add one, through new
files only (an architecture, its reference, a configuration that names
it), and runs the tiny serving and training cells through the drivers:
the check passes, the float8 control fails, and the stand-in's kinds,
global kinds, model, counts and reference are the ones called.  The
decoder's draw, names and counts are pinned to the values they had before
architectures were modules.

The stand-in's training check compares the loss and the first gradient
and not the change after three steps: the key bias's gradient is all but
nought under softmax (RoPE leaves it 6-8% of the median leaf's), so Adam
moves its elements by round-off, and that leaf's change reads 0.0007-0.0066
on sound runs against the float8 control's 0.0037-0.0086 (seeds 1-4, bias
std 0.1-0.5, CPU): no upper reading.  The first gradient separates them
(0.0010-0.0026 against 0.011-0.026)."""

import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import arch, counts, port, weights
from portbench.tests import tiny

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
STANDIN = pathlib.Path(__file__).resolve().parent / "standin"
CONTRACT = ("from_dict", "kinds", "GLOBAL", "model_config", "param_name", "prefill_flops",
            "decode_flops", "decode_bytes", "train_flops")

RUN_STANDIN = r"""
import json, sys, time
import torch
from portbench import arch, harness, weights
from portbench.reference import decoder as plain
from portbench.tests import tiny

cpu = torch.device("cpu")
config = arch.load_dict("tiny-qkv")
a = arch.from_dict(config)
cell = dict(getattr(tiny, sys.argv[1]), config="tiny-qkv")
if cell["driver"] == "train":  # the key bias's change has no upper reading (docstring)
    limits = {k: v for k, v in cell["check"]["limits"].items() if k != "update_gap"}
    cell["check"] = dict(limits=limits)
drv = harness.driver(cell["driver"])
out = dict(arch=a.arch, runs=[])
for seed in (1, 2):
    rec, checks = harness.run_cell(cell, config, seed, 0.0, True, cpu, time.perf_counter(),
                                   control=True)
    if cell["driver"] == "serve":
        control = dict(checks, logit_gap=checks["control_logit_gap"])
    else:
        ctx = dict(arch=a, cell=cell, seed=seed, device=cpu)
        control = drv.check(ctx, drv.follow(ctx, lowp=True))
    metrics = harness.read_metrics([(n, "%") for n in sys.argv[2:]], rec)
    out["runs"].append(dict(checks=checks, ok=harness.judge(cell, checks)[0],
                            control_ok=harness.judge(cell, control)[0],
                            metrics={k: v["value"] for k, v in metrics.items()}))
mod, ref = arch.module(a), arch.reference(a)
W = dict(weights.draw(a, 1, cpu, torch.float32))
toks = torch.randint(1, a.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
out["bias_moves_logits"] = float((ref.served_logits(a, W, toks, 8) - plain.served_logits(
    a, dict(W, final_norm=W["ln_f"]), toks, 8)).abs().max())
out["global_leaves"] = [key for key, _, i in weights.leaves(a) if i is None]
out.update(calls=sorted(mod.CALLS), ref_calls=sorted(ref.CALLS), arch_file=mod.__file__,
           ref_file=ref.__file__, forbidden=harness.forbidden_modules())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def standin_copy(tmp_path_factory):
    """A copy of the benchmark with the stand-in's three files added."""
    root = tmp_path_factory.mktemp("standin")
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(STANDIN / "archs" / "qkv_bias.py", bench / "archs" / "qkv_bias.py")
    shutil.copy(STANDIN / "reference" / "qkv_bias.py", bench / "reference" / "qkv_bias.py")
    (bench / "configs" / "tiny-qkv.json").write_text(
        json.dumps(dict(tiny.DENSE, name="tiny-qkv", arch="qkv_bias")))
    return root


@pytest.mark.parametrize("cell,metrics,calls", [
    ("SERVE", ["decode_roofline_pct.serve", "mfu.serve"],
     {"decode_bytes", "decode_flops", "prefill_flops"}),
    ("TRAIN", ["mfu.train"], {"train_flops"}),
], ids=["serve", "train"])
def test_a_new_architecture_enters_through_new_files(standin_copy, cell, metrics, calls):
    out = subprocess.run([sys.executable, "-c", RUN_STANDIN, cell, *metrics], cwd=standin_copy,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{standin_copy}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["arch"] == "qkv_bias" and got["forbidden"] == []
    assert got["arch_file"] == str(standin_copy / "portbench" / "archs" / "qkv_bias.py")
    assert got["ref_file"] == str(standin_copy / "portbench" / "reference" / "qkv_bias.py")
    for run in got["runs"]:
        assert run["ok"], run["checks"]
        assert not run["control_ok"], run["checks"]
        assert set(run["metrics"]) == set(metrics)
        assert all(0 < v < 100 for v in run["metrics"].values()), run["metrics"]
    assert {"kinds", "model_config", "param_name"} | calls <= set(got["calls"])
    want_ref = {"served_logits", "hidden", "unembed"} if cell == "SERVE" else {"hidden", "unembed"}
    assert want_ref <= set(got["ref_calls"])
    # the biases matter: the decoder's reference would judge other logits
    assert got["bias_moves_logits"] > 0.1
    # its global kinds are its own: ln_f is one leaf, where the decoder's GLOBAL would stack it
    assert got["global_leaves"] == ["tok", "ln_f"]


def test_no_file_of_the_benchmark_names_the_standin():
    assert not (BENCH / "archs" / "qkv_bias.py").exists()
    assert not (BENCH / "reference" / "qkv_bias.py").exists()
    for p in BENCH.rglob("*.py"):
        if "tests" not in p.relative_to(BENCH).parts:
            assert "qkv_bias" not in p.read_text(), p


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH / "archs").glob("*.py")))
def test_architecture_module_provides_the_contract(name):
    mod = arch.module_named(name)
    assert all(hasattr(mod, k) for k in CONTRACT), name
    a = mod.from_dict(dict(tiny.DENSE, arch=name))
    assert set(mod.GLOBAL) <= {kind for kind, _, _ in mod.kinds(a)} | {"unembed"}
    ref = arch.reference(a)
    assert ref.__file__ == str(BENCH / "reference" / f"{name}.py")
    assert all(hasattr(ref, k) for k in ("served_logits", "hidden", "unembed"))


def test_a_file_without_arch_is_the_decoder_and_an_unknown_arch_is_refused():
    a = arch.from_dict(tiny.DENSE)
    assert a.arch == "decoder" and arch.module(a) is arch.module_named("decoder")
    assert arch.reference(a).__name__ == "portbench.reference.decoder"
    with pytest.raises(FileNotFoundError, match="no arch 'nonesuch'"):
        arch.from_dict(dict(tiny.DENSE, arch="nonesuch"))


# The decoder's values before architectures were modules: kinds (shape,
# std) in draw order, the number of leaves and the sha256 of their
# parameter names joined by newlines, and counts at the cells' shapes.
S = {"d2304": 0.020833333333333332, "f5760": 0.013176156917368247,
     "d2048": 0.022097086912079608, "f10944": 0.009558988911273407,
     "f1408": 0.026650089544451302, "f2816": 0.018844459036110227,
     "d64": 0.125, "f128": 0.08838834764831843, "f32": 0.17677669529663687}
TINY_MOE_KINDS = [
    ("tok", (320, 64), 0.0025), ("final_norm", (64,), 0.1), ("norm1", (3, 64), 0.1),
    ("norm2", (3, 64), 0.1), ("wq", (3, 64, 64), S["d64"]), ("wk", (3, 64, 64), S["d64"]),
    ("wv", (3, 64, 64), S["d64"]), ("wo", (3, 64, 64), S["d64"]),
    ("w_gate", (1, 64, 128), S["d64"]), ("w_up", (1, 64, 128), S["d64"]),
    ("w_down", (1, 128, 64), S["f128"]), ("router", (2, 64, 8), S["d64"]),
    ("we_gate", (2, 8, 64, 32), S["d64"]), ("we_up", (2, 8, 64, 32), S["d64"]),
    ("we_down", (2, 8, 32, 64), S["f32"]), ("ws_gate", (2, 64, 32), S["d64"]),
    ("ws_up", (2, 64, 32), S["d64"]), ("ws_down", (2, 32, 64), S["f32"])]
PINNED = {
    "minicpm-2b": dict(
        tok_scale=0.02,
        kinds=[("tok", (122880, 2304), 0.0004166666666666667), ("final_norm", (2304,), 0.1),
               ("norm1", (40, 2304), 0.1), ("norm2", (40, 2304), 0.1),
               ("wq", (40, 2304, 2304), S["d2304"]), ("wk", (40, 2304, 2304), S["d2304"]),
               ("wv", (40, 2304, 2304), S["d2304"]), ("wo", (40, 2304, 2304), S["d2304"]),
               ("w_gate", (40, 2304, 5760), S["d2304"]), ("w_up", (40, 2304, 5760), S["d2304"]),
               ("w_down", (40, 5760, 2304), S["f5760"])],
        names=(362, "591a9f69e1a806751477f5ba5e2082fe2eccfc8414ec3852b2f50617aee6bf79"),
        counts=[("prefill_flops", (32, 2048), 344830154784768),
                ("decode_flops", (32, 2176), 200049573888),
                ("decode_bytes", (32, 2176), 31138702400),
                ("train_flops", (2, 2048), 71602916032512)]),
    "deepseek-moe-16b": dict(
        tok_scale=1.0,
        kinds=[("tok", (102400, 2048), S["d2048"]), ("final_norm", (2048,), 0.1),
               ("norm1", (28, 2048), 0.1), ("norm2", (28, 2048), 0.1),
               ("wq", (28, 2048, 2048), S["d2048"]), ("wk", (28, 2048, 2048), S["d2048"]),
               ("wv", (28, 2048, 2048), S["d2048"]), ("wo", (28, 2048, 2048), S["d2048"]),
               ("w_gate", (1, 2048, 10944), S["d2048"]), ("w_up", (1, 2048, 10944), S["d2048"]),
               ("w_down", (1, 10944, 2048), S["f10944"]), ("router", (27, 2048, 64), S["d2048"]),
               ("we_gate", (27, 64, 2048, 1408), S["d2048"]),
               ("we_up", (27, 64, 2048, 1408), S["d2048"]),
               ("we_down", (27, 64, 1408, 2048), S["f1408"]),
               ("ws_gate", (27, 2048, 2816), S["d2048"]), ("ws_up", (27, 2048, 2816), S["d2048"]),
               ("ws_down", (27, 2816, 2048), S["f2816"]),
               ("unembed", (2048, 102400), S["d2048"])],
        names=(363, "a070d51eed20ac0d1cb6bc4c4fdd86b5de4364eaaf24b8f92cbbeebdd47a09db"),
        counts=[("prefill_flops", (256, 256), 317805031325696),
                ("decode_flops", (256, 384), 1363383681024),
                ("decode_bytes", (256, 384), 54992801792),
                ("decode_bytes", (256, 384, 30.5), 39343591424.0)]),
    "tiny-dense": dict(
        tok_scale=0.02,
        kinds=[("tok", (320, 64), 0.0025), ("final_norm", (64,), 0.1), ("norm1", (2, 64), 0.1),
               ("norm2", (2, 64), 0.1), ("wq", (2, 64, 64), S["d64"]),
               ("wk", (2, 64, 64), S["d64"]), ("wv", (2, 64, 64), S["d64"]),
               ("wo", (2, 64, 64), S["d64"]), ("w_gate", (2, 64, 128), S["d64"]),
               ("w_up", (2, 64, 128), S["d64"]), ("w_down", (2, 128, 64), S["f128"])],
        names=(20, "291699ef761cdb8cacce798875c90fe392c9d36ed186cd29bd373296bde93a64"),
        counts=[("prefill_flops", (4, 16), 10917888), ("decode_flops", (4, 40), 890880),
                ("decode_bytes", (4, 40), 289760), ("train_flops", (2, 32), 40452096)]),
    "tiny-moe": dict(
        tok_scale=0.02, kinds=TINY_MOE_KINDS,
        names=(37, "ebae64b41476a367fbb6956947126297ce187cde3efed153e5a32f01d87332d5"),
        counts=[("prefill_flops", (4, 16), 14858240), ("decode_flops", (4, 40), 1169408),
                ("decode_bytes", (4, 40), 538848), ("decode_bytes", (4, 40, 5.5), 477408.0)]),
    "tiny-moe-untied": dict(
        tok_scale=0.02, kinds=TINY_MOE_KINDS + [("unembed", (64, 320), S["d64"])],
        names=(38, "479916d480340c616c555a026c4a11a4c03c134073859f2b0c0f6be048c79200"),
        counts=[("prefill_flops", (4, 16), 14858240), ("decode_flops", (4, 40), 1169408),
                ("decode_bytes", (4, 40), 538848), ("decode_bytes", (4, 40, 5.5), 477408.0)]),
}
TINY = {"tiny-dense": tiny.DENSE, "tiny-moe": tiny.MOE, "tiny-moe-untied": tiny.MOE_UNTIED}


def _config(name):
    return TINY[name] if name in TINY else arch.load_dict(name)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_decoder_draw_names_and_counts_are_pinned(name):
    pin, a = PINNED[name], arch.from_dict(_config(name))
    mod = arch.module(a)
    assert a.arch == "decoder"
    assert mod.kinds(a, pin["tok_scale"]) == weights.kinds(a, pin["tok_scale"]) == pin["kinds"]
    names = [mod.param_name(a, kind, i) for _, kind, i in weights.leaves(a)]
    assert names == [port.param_name(a, kind, i) for _, kind, i in weights.leaves(a)]
    assert (len(names), hashlib.sha256("\n".join(names).encode()).hexdigest()) == pin["names"]
    for fn, args, want in pin["counts"]:
        assert getattr(mod, fn)(a, *args) == getattr(counts, fn)(a, *args) == want, fn
    cfg = mod.model_config(a)
    assert cfg == port.model_config(a)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.pattern, cfg.qkv_bias) == (
        a.n_layers, a.d_model, a.n_heads, a.head_dim, ("attn",), False)
