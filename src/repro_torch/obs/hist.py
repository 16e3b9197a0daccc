"""Log-bucketed streaming histograms with *fixed* bucket edges.

The port of ``repro.obs.hist``: the same float expressions in the same
order, so every bucket index matches the reference bit for bit.

The telemetry plane needs distributions — latency, round trips,
bytes, queue waits — that are

* **deterministic**: the same op stream produces bit-identical histograms
  on every run (integer bucket counts, edges derived from IEEE-754
  ``frexp`` — no float accumulation order anywhere);
* **mergeable**: merging is per-bucket integer addition, so it is exactly
  associative and commutative (multi-shard / multi-replica roll-ups
  cannot drift with aggregation order);
* **JSON-round-trippable**: a histogram serialises to sparse
  ``{bucket_index: count}`` plus the bucket-edge spec, and reconstructs
  bit-identically.

Bucket-edge spec (``HIST_SPEC``, documented in docs/OBSERVABILITY.md):
HDR-style log2 buckets with ``SUBBUCKETS`` linear sub-buckets per octave.
Bucket 0 holds ``[0, 1)``; for ``v >= 1`` with ``v = frac * 2**exp``
(``frexp``, ``frac in [0.5, 1)``) the index is
``1 + (exp - 1) * SUBBUCKETS + floor((frac - 0.5) * 2 * SUBBUCKETS)``.
Relative bucket width is ``1/SUBBUCKETS`` (12.5%), so quantile estimates
carry at most ~6% relative error — plenty for p50/p99/p999 curves whose
exact values the benches also record.  Values beyond ``2**MAX_OCTAVE``
clamp into the last (overflow) bucket.
"""

from __future__ import annotations

import math

import numpy as np

SUBBUCKETS = 8      # linear sub-buckets per power-of-two octave
MAX_OCTAVE = 44     # last finite edge 2**44 (~1.8e13: µs, bytes, counts all fit)
N_BUCKETS = 1 + MAX_OCTAVE * SUBBUCKETS  # incl. the [0,1) and overflow buckets

HIST_SPEC = {"scheme": "log2-linear", "subbuckets": SUBBUCKETS,
             "max_octave": MAX_OCTAVE, "n_buckets": N_BUCKETS}


def bucket_index(v: float) -> int:
    """The fixed bucket index of a non-negative value (scalar path)."""
    if v < 1.0:
        return 0
    frac, exp = math.frexp(v)  # v = frac * 2**exp, frac in [0.5, 1)
    idx = 1 + (exp - 1) * SUBBUCKETS + int((frac - 0.5) * 2 * SUBBUCKETS)
    return idx if idx < N_BUCKETS else N_BUCKETS - 1


def bucket_indices(values) -> np.ndarray:
    """Vectorised :func:`bucket_index` (exactly the scalar result)."""
    v = np.asarray(values, dtype=np.float64)
    frac, exp = np.frexp(np.maximum(v, 1.0))
    idx = (1 + (exp.astype(np.int64) - 1) * SUBBUCKETS
           + ((frac - 0.5) * (2 * SUBBUCKETS)).astype(np.int64))
    return np.where(v < 1.0, 0, np.minimum(idx, N_BUCKETS - 1))


def bucket_lo(idx: int) -> float:
    """Inclusive lower edge of bucket ``idx``."""
    if idx <= 0:
        return 0.0
    octave, sub = divmod(idx - 1, SUBBUCKETS)
    return (0.5 + sub / (2 * SUBBUCKETS)) * float(2 ** (octave + 1))


def bucket_hi(idx: int) -> float:
    """Exclusive upper edge of bucket ``idx`` (``inf`` for the overflow)."""
    if idx >= N_BUCKETS - 1:
        return float("inf")
    return bucket_lo(idx + 1)


# integer upper bounds per bucket (ceil of the exclusive edge), so the
# flush path's record_range walks buckets without per-step float math
_INT_UPPER = [math.ceil(bucket_hi(i)) if i < N_BUCKETS - 1 else None
              for i in range(N_BUCKETS)]


class LogHistogram:
    """Sparse streaming histogram over the fixed log2 bucket grid.

    State is integer-only where determinism matters: sparse bucket counts
    and the total.  The observed ``min``/``max`` are kept for reporting
    (their combine is min/max — also exactly associative).
    """

    __slots__ = ("counts", "n", "vmin", "vmax")

    def __init__(self) -> None:
        self.counts: dict[int, int] = {}
        self.n = 0
        self.vmin: float | None = None
        self.vmax: float | None = None

    # ------------------------------------------------------------ recording
    def record(self, value: float, n: int = 1) -> None:
        """Record ``n`` observations of ``value`` (negatives clamp to 0)."""
        if n <= 0:
            return
        v = float(value)
        if v < 0.0:
            v = 0.0
        idx = bucket_index(v)
        self.counts[idx] = self.counts.get(idx, 0) + int(n)
        self.n += int(n)
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    def record_many(self, values, weights=None) -> None:
        """Record an array of observations in one vectorised pass.

        ``weights`` (optional, integer per-value counts) records each
        value as that many observations — the flush path's per-entry lane
        counts land in one call instead of a Python loop."""
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return
        v = np.maximum(v, 0.0)
        if weights is None:
            idx, cnt = np.unique(bucket_indices(v), return_counts=True)
            n_new = int(v.size)
        else:
            w = np.asarray(weights, dtype=np.int64)
            keep = w > 0
            if not keep.all():
                v, w = v[keep], w[keep]
            if v.size == 0:
                return
            idx, inv = np.unique(bucket_indices(v), return_inverse=True)
            cnt = np.bincount(inv, weights=w).astype(np.int64)
            n_new = int(w.sum())
        for i, c in zip(idx, cnt):
            i = int(i)
            self.counts[i] = self.counts.get(i, 0) + int(c)
        self.n += n_new
        lo, hi = float(v.min()), float(v.max())
        if self.vmin is None or lo < self.vmin:
            self.vmin = lo
        if self.vmax is None or hi > self.vmax:
            self.vmax = hi

    def record_range(self, start: int, stop: int) -> None:
        """Record every integer in ``[start, stop)`` once, in O(buckets).

        Bit-identical to ``record_many(np.arange(start, stop))`` — the
        flush path uses it when a coalesced group's queue waits form a
        consecutive integer range (dense scalar runs), replacing the
        per-entry array build with a walk over the few buckets the range
        spans.  Negatives clamp into bucket 0, like :meth:`record`."""
        start, stop = int(start), int(stop)
        if stop <= start:
            return
        idx = bucket_index(max(start, 0))
        cursor = start
        counts = self.counts
        while cursor < stop:
            hi = _INT_UPPER[idx]  # exclusive integer upper bound
            upper = stop if hi is None or hi > stop else hi
            if upper > cursor:  # skip sub-1 buckets holding no integers
                counts[idx] = counts.get(idx, 0) + (upper - cursor)
                cursor = upper
            idx += 1
        self.n += stop - start
        lo, hi = float(max(start, 0)), float(max(stop - 1, 0))
        if self.vmin is None or lo < self.vmin:
            self.vmin = lo
        if self.vmax is None or hi > self.vmax:
            self.vmax = hi

    # ----------------------------------------------------------- combining
    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Per-bucket integer addition — exactly associative/commutative."""
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.n += other.n
        if other.vmin is not None and (self.vmin is None
                                       or other.vmin < self.vmin):
            self.vmin = other.vmin
        if other.vmax is not None and (self.vmax is None
                                       or other.vmax > self.vmax):
            self.vmax = other.vmax
        return self

    def copy(self) -> "LogHistogram":
        """An independent snapshot of the current state."""
        h = LogHistogram()
        h.counts = dict(self.counts)
        h.n, h.vmin, h.vmax = self.n, self.vmin, self.vmax
        return h

    # ------------------------------------------------------------- queries
    def percentile(self, q: float) -> float:
        """Deterministic quantile estimate (bucket-midpoint rule).

        Walks the sparse buckets in index order until the cumulative count
        covers ``q`` percent, then returns that bucket's midpoint (the
        observed ``min``/``max`` bound the first/last bucket, so the
        estimate never leaves the observed range)."""
        if self.n == 0:
            return 0.0
        target = max(1, int(math.ceil(q / 100.0 * self.n)))
        cum = 0
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum >= target:
                lo = max(bucket_lo(idx), 0.0 if self.vmin is None
                         else self.vmin)
                hi = bucket_hi(idx)
                if self.vmax is not None:
                    hi = min(hi, self.vmax)
                hi = max(hi, lo)
                return (lo + hi) / 2.0
        return float(self.vmax or 0.0)

    def total(self) -> int:
        """Sum of all bucket counts (== ``n``; used by integrity checks)."""
        return sum(self.counts.values())

    # ---------------------------------------------------------------- json
    def to_json_dict(self) -> dict:
        """Serialise: sparse counts + edge spec; reconstructs bit-identically."""
        return {"spec": dict(HIST_SPEC),
                "counts": {str(i): self.counts[i]
                           for i in sorted(self.counts)},
                "n": self.n, "min": self.vmin, "max": self.vmax}

    @classmethod
    def from_json_dict(cls, d: dict) -> "LogHistogram":
        """Rebuild a histogram serialised by :meth:`to_json_dict`."""
        spec = d.get("spec")
        if spec != HIST_SPEC:
            raise ValueError(f"histogram bucket spec mismatch: {spec!r} "
                             f"vs {HIST_SPEC!r}")
        h = cls()
        h.counts = {int(k): int(v) for k, v in d["counts"].items()}
        h.n = int(d["n"])
        h.vmin = None if d["min"] is None else float(d["min"])
        h.vmax = None if d["max"] is None else float(d["max"])
        return h

    def __eq__(self, other) -> bool:
        if not isinstance(other, LogHistogram):
            return NotImplemented
        return (self.counts == other.counts and self.n == other.n
                and self.vmin == other.vmin and self.vmax == other.vmax)

    def __repr__(self) -> str:
        return (f"LogHistogram(n={self.n}, min={self.vmin}, max={self.vmax}, "
                f"buckets={len(self.counts)})")
