"""Deterministic, shardable token pipeline (numpy only; the port's own
copy of the reference's, so a batch is bit-equal to the reference's for
the same ``(seed, step, host, n_hosts)``).

Two sources:
  * ``SyntheticSource`` — seeded token generation (Zipf-ish marginals so the
    loss curve is non-trivial); fully deterministic in (seed, step, host).
  * ``MemmapSource`` — flat binary token file (np.memmap), block-sharded by
    host: host h of H reads blocks [h::H] — restart-safe and elastic (a
    re-scale to H' hosts re-partitions deterministically from the step
    counter alone, no iterator state to checkpoint).

Straggler/fault posture: every batch is a pure function of (step, host
count, host id), so a restarted or re-assigned host reproduces exactly the
batch the failed host would have produced — no data-loss bookkeeping.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticSource:
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch(self, step: int, host: int, n_hosts: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host, n_hosts])
        )
        # Zipf-distributed ids clipped to vocab (cheap, heavy-tailed)
        z = rng.zipf(self.zipf_a, size=(batch, seq + 1)).astype(np.int64)
        return (z % self.vocab_size).astype(np.int32)


@dataclasses.dataclass
class MemmapSource:
    path: str
    vocab_size: int

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")

    def batch(self, step: int, host: int, n_hosts: int, batch: int, seq: int) -> np.ndarray:
        n_tok = seq + 1
        total = self._data.shape[0] // n_tok
        out = np.empty((batch, n_tok), np.int32)
        for i in range(batch):
            gidx = (step * n_hosts * batch + host * batch + i) % total
            out[i] = self._data[gidx * n_tok : (gidx + 1) * n_tok]
        return np.clip(out, 0, self.vocab_size - 1)


@dataclasses.dataclass
class DataConfig:
    batch_per_host: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    path: str | None = None


class Pipeline:
    """Yields {tokens, labels, mask} host-local batches."""

    def __init__(self, cfg: DataConfig, host: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host = host
        self.n_hosts = n_hosts
        self.source = (
            MemmapSource(cfg.path, cfg.vocab_size)
            if cfg.path
            else SyntheticSource(cfg.vocab_size, cfg.seed)
        )

    def get_batch(self, step: int) -> dict:
        c = self.cfg
        raw = self.source.batch(step, self.host, self.n_hosts, c.batch_per_host, c.seq_len)
        return dict(
            tokens=raw[:, :-1],
            labels=raw[:, 1:],
            mask=np.ones((c.batch_per_host, c.seq_len), np.float32),
        )
