"""Traffic of the benchmark's cells, from ``--seed`` and a workload file's
``traffic`` parameters alone.

``closed_waves`` (serving): ``clients`` clients in a closed loop on a
batch of as many slots; each sends its next request when the last one of
the wave has ended, so the requests of a wave start and end together.
Every wave holds the same sizes, the distribution's quantiles at
``(i + 0.5) / clients`` (prompt lengths log-uniform, output lengths
uniform), dealt to the clients in an order drawn from the seed; the
prompts' token ids are drawn from the seed too.  So every seed asks for
the same work, in another order, and two runs of one seed send the same
requests.

``synthetic_lm`` (training): the port's `SyntheticSource` (Zipf-marginal
ids, ``zipf_a``) copied here: batch ``step`` is a pure function of
``(seed, step)``, of ``batch`` sequences of ``seq + 1`` ids (inputs and
next-token labels).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .weights import sub_seed


@dataclasses.dataclass(frozen=True)
class Request:
    """One request: its prompt (int32 ids, no pads) and output tokens wanted."""

    uid: int
    prompt: np.ndarray
    max_new: int


def _sizes(spec: dict, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    lo, hi = float(spec["lo"]), float(spec["hi"])
    if spec["dist"] == "log_uniform":
        v = lo * (hi / lo) ** q
    elif spec["dist"] == "uniform":
        v = lo + q * (hi - lo)
    else:
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def wave(traffic: dict, vocab_size: int, seed: int, index: int) -> list[Request]:
    """Wave ``index`` of a ``closed_waves`` mix (index -1: the warm-up's)."""
    if traffic["kind"] != "closed_waves":
        raise ValueError(f"not a serving mix: {traffic['kind']!r}")
    n = int(traffic["clients"])
    rng = np.random.default_rng([sub_seed(seed, "traffic"), index + 1])
    plen = _sizes(traffic["prompt_len"], n)[rng.permutation(n)]
    mnew = _sizes(traffic["max_new"], n)[rng.permutation(n)]
    # ids from 1: 0 is the pad the engine puts before short prompts
    return [Request(uid=index * n + i,
                    prompt=rng.integers(1, vocab_size, size=int(plen[i])).astype(np.int32),
                    max_new=int(mnew[i]))
            for i in range(n)]


def train_batch(traffic: dict, vocab_size: int, seed: int, step: int) -> np.ndarray:
    """Batch ``step`` of a ``synthetic_lm`` mix: (batch, seq + 1) int32 ids."""
    if traffic["kind"] != "synthetic_lm":
        raise ValueError(f"not a training mix: {traffic['kind']!r}")
    rng = np.random.default_rng(np.random.SeedSequence([sub_seed(seed, "traffic"), step, 0, 1]))
    z = rng.zipf(float(traffic["zipf_a"]), size=(int(traffic["batch"]), int(traffic["seq"]) + 1))
    return (z.astype(np.int64) % vocab_size).astype(np.int32)
