"""A stand-in architecture for the tests of the seam: the decoder with
biases on q, k and v (the port's ``ModelConfig.qkv_bias``, as
qwen1.5-4b runs).  A test copies it to ``archs/qkv_bias.py`` of a copy of
the benchmark, as a later PR would add an architecture, beside its
reference (``standin/reference/qkv_bias.py``) and a configuration whose
``"arch"`` is ``"qkv_bias"``.  ``CALLS`` names the functions of this
module that were called.

Its final norm's gain is a global kind of its own name, ``ln_f``, which
the decoder's ``GLOBAL`` does not hold: the port's decoder has no global
parameter beyond the decoder's three, so this is how the stand-in shows
that the shared code takes the global kinds from the architecture."""

import dataclasses

from portbench import arch

decoder = arch.module_named("decoder")
GLOBAL = ("tok", "ln_f", "unembed")
BIAS_STD = 0.5
CALLS: set = set()

from_dict = decoder.from_dict  # the decoder's numbers, ``arch`` read from the file


def _called(f):
    def g(*args, **kw):
        CALLS.add(f.__name__)
        return f(*args, **kw)

    g.__name__ = f.__name__
    return g


def _bias_params(a) -> int:
    return a.n_layers * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim


@_called
def kinds(a, tok_scale: float = 1.0):
    L, hd = a.n_layers, a.head_dim
    named = [("ln_f", *k[1:]) if k[0] == "final_norm" else k for k in decoder.kinds(a, tok_scale)]
    return named + [
        ("bq", (L, a.n_heads * hd), BIAS_STD),
        ("bk", (L, a.n_kv_heads * hd), BIAS_STD),
        ("bv", (L, a.n_kv_heads * hd), BIAS_STD)]


@_called
def model_config(a):
    return dataclasses.replace(decoder.model_config(a), qkv_bias=True)


@_called
def param_name(a, kind, index):
    if kind in ("bq", "bk", "bv"):
        return f"layers.{index}.attn.{kind}"
    if kind == "ln_f":
        return "final_norm"
    return decoder.param_name(a, kind, index)


@_called
def prefill_flops(a, batch, seq):
    return decoder.prefill_flops(a, batch, seq) + batch * seq * _bias_params(a)


@_called
def decode_flops(a, batch, attended):
    return decoder.decode_flops(a, batch, attended) + batch * _bias_params(a)


@_called
def decode_bytes(a, batch, attended, experts_hit=None, wbytes=2, kvbytes=2, logit_bytes=2):
    return (decoder.decode_bytes(a, batch, attended, experts_hit, wbytes, kvbytes, logit_bytes)
            + _bias_params(a) * wbytes)


@_called
def train_flops(a, batch, seq):
    return decoder.train_flops(a, batch, seq) + 3 * batch * seq * _bias_params(a)
