"""Deterministic synthetic data pipeline with restart replay: the
reference's ``train/data.py`` over the port's ``core/hashing``.

Batches are a pure function of ``(seed, step)`` and are numpy arrays, bit
for bit the reference's: a restarted job replays exactly the same global
batch sequence.  A bounded host-side prefetch queue decouples generation
from the step loop; per-step deadlines are recorded so input-side
stragglers show up in the stats.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from repro_torch.core.hashing import splitmix64


@dataclasses.dataclass
class PipelineStats:
    produced: int = 0
    late: int = 0
    gen_seconds: float = 0.0


class SyntheticLM:
    """Next-token stream over a hashed token sequence (uniform vocab)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, frontend: str | None = None,
                 d_model: int = 0, aux_len: int = 0):
        self.vocab = vocab
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.frontend = frontend
        self.d_model = d_model
        self.aux_len = aux_len

    def global_batch_at(self, step: int) -> dict:
        idx = (np.uint64(self.seed) << np.uint64(40)) \
            + np.uint64(step) * np.uint64(self.batch * (self.seq + 1)) \
            + np.arange(self.batch * (self.seq + 1), dtype=np.uint64)
        toks = (splitmix64(idx) % np.uint64(self.vocab)).astype(np.int32)
        toks = toks.reshape(self.batch, self.seq + 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend in ("vision", "audio"):
            h = splitmix64(idx[: self.batch * self.aux_len]).astype(np.uint32)
            emb = (h.astype(np.float32) / 2**31 - 1.0).reshape(
                self.batch, self.aux_len, 1)
            out["patches" if self.frontend == "vision" else "frames"] = \
                np.broadcast_to(emb, (self.batch, self.aux_len,
                                      self.d_model)).copy() * 0.02
        return out


class Prefetcher:
    """Bounded synchronous prefetch with deadline accounting."""

    def __init__(self, source: SyntheticLM, *, depth: int = 2,
                 deadline_s: float = 1.0):
        self.source = source
        self.depth = depth
        self.deadline = deadline_s
        self.buf: collections.deque = collections.deque()
        self.next_step = 0
        self.stats = PipelineStats()

    def seek(self, step: int) -> None:
        self.buf.clear()
        self.next_step = step

    def _fill(self) -> None:
        while len(self.buf) < self.depth:
            t0 = time.perf_counter()
            self.buf.append(self.source.global_batch_at(self.next_step))
            dt = time.perf_counter() - t0
            self.stats.gen_seconds += dt
            self.stats.produced += 1
            if dt > self.deadline:
                self.stats.late += 1
            self.next_step += 1

    def get(self) -> dict:
        self._fill()
        return self.buf.popleft()
