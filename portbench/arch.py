"""A configuration file of the benchmark, read into the shapes every other
part of it uses, and the architecture that reads it.

A file under ``configs/`` holds the model's published ``config.json`` keys
as the port runs them (``reduced`` names the ones that differ from the
source) and a few keys of the port's own (``head_dim``,
``vocab_pad_multiple``, ``capacity_factor``).  Its optional ``"arch"`` key
names the architecture, a module ``archs/<arch>.py`` (``decoder`` where
the key is absent), which provides:

- ``from_dict(config)``: the file as numbers, an object with at least
  ``arch`` (the module's name), ``name``, ``vocab_size`` and ``is_moe``
  (its batch is one routing group, so a serving check judges whole waves);
- ``kinds(a, tok_scale=1.0)``: ``(kind, stacked shape, std)`` of every
  kind of leaf, in draw order (`weights`);
- ``GLOBAL``: the kinds held once (one leaf each); every other kind is
  stacked over the layers that hold it, one leaf a layer;
- ``model_config(a)`` and ``param_name(a, kind, index)``: the port's
  ``ModelConfig`` and the parameter that holds one leaf (`port`);
- ``prefill_flops``, ``decode_flops``, ``decode_bytes``, ``train_flops``:
  the work a step needs, with the signatures of `counts`;

Its plain reference is ``reference/<arch>.py``, of the same name, which
provides ``served_logits``, ``hidden`` and ``unembed`` as
`reference.decoder` does (the training reference reads the last two).  It
is found by that name alone (`reference`): the architecture module reaches
the program through `port`, and the reference never loads it.

`Arch` is the decoder's numbers (`read_decoder`); the reference, the counts
and the weights read nothing else.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

from . import found

HERE = pathlib.Path(__file__).resolve().parent
DEFAULT = "decoder"  # the architecture of a configuration file without an "arch" key


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # the dense FFN's width (every layer of a dense model, the leading ones of an MoE)
    vocab_size: int
    vocab_pad_multiple: int
    tie_embeddings: bool
    norm_eps: float
    rope_theta: float
    act: str
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    arch: str = DEFAULT  # the module under archs/ that read the file

    @property
    def padded_vocab(self) -> int:
        m = max(1, self.vocab_pad_multiple)
        return -(-self.vocab_size // m) * m

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def dense_layers(self) -> int:
        """Layers with the dense FFN: all of them, or the leading ones of an MoE."""
        return self.first_dense_layers if self.is_moe else self.n_layers

    @property
    def moe_layers(self) -> int:
        return self.n_layers - self.dense_layers if self.is_moe else 0

    def capacity(self, n_tokens: int) -> int:
        """Slots an expert has in a routing group of ``n_tokens`` tokens."""
        cap = int(math.ceil(n_tokens * self.top_k / self.n_experts * self.capacity_factor))
        return min(max(cap, 8), n_tokens * self.top_k)


def read_decoder(c: dict) -> Arch:
    """The published keys (Hugging Face names) of a decoder's configuration
    file."""
    n_exp = int(c.get("n_routed_experts") or 0)
    hd = int(c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"])
    return Arch(
        name=c["name"],
        n_layers=int(c["num_hidden_layers"]),
        d_model=int(c["hidden_size"]),
        n_heads=int(c["num_attention_heads"]),
        n_kv_heads=int(c["num_key_value_heads"]),
        head_dim=hd,
        d_ff=int(c["intermediate_size"]),
        vocab_size=int(c["vocab_size"]),
        vocab_pad_multiple=int(c.get("vocab_pad_multiple", 1)),
        tie_embeddings=bool(c["tie_word_embeddings"]),
        norm_eps=float(c["rms_norm_eps"]),
        rope_theta=float(c["rope_theta"]),
        act=c["hidden_act"],
        n_experts=n_exp,
        n_shared_experts=int(c.get("n_shared_experts") or 0),
        top_k=int(c.get("num_experts_per_tok") or 0),
        moe_d_ff=int(c.get("moe_intermediate_size") or 0),
        first_dense_layers=int(c.get("first_k_dense_replace") or 0),
        capacity_factor=float(c.get("capacity_factor", 1.25)),
        norm_topk_prob=bool(c.get("norm_topk_prob", True)),
        arch=c.get("arch", DEFAULT),
    )


def module_named(name: str):
    """The architecture module ``archs/<name>.py``."""
    return found.load("archs", name)


def module(a):
    """The architecture module that read ``a``."""
    return module_named(a.arch)


def reference(a):
    """The plain reference of ``a``'s architecture, ``reference/<arch>.py``."""
    return found.load("reference", a.arch)


def from_dict(c: dict):
    """A configuration file as numbers, read by the architecture it names."""
    return module_named(c.get("arch", DEFAULT)).from_dict(c)


def load(name: str):
    return from_dict(load_dict(name))


def load_dict(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)
