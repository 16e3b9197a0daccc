"""``repro_torch.cluster.coherence`` — per-shard invalidation epochs across
CNs (the port of ``repro.cluster.coherence``, host numpy).

The single-CN stack's cache coherence (``bind_coherence_cache``) assumes
one writer: the engine invalidates the one CN cache at split sync points
and the cache layer observes its own mutations.  With N CNs writing the
same shards that breaks — CN j's cache can hold a value CN i just
overwrote.

The cluster closes the gap with **invalidation epochs**: a per-shard
counter bumped by every write that touches the shard, piggybacked on the
round trips the writer already issues (zero extra wire — receivers learn
the epoch from the next message they exchange, exactly how Outback
piggybacks seed versions on Makeup-Get).  Each CN tracks the last epoch
it has *seen* per shard; before any cache probe the gate compares and,
on a mismatch, drops every cached entry routed to the stale shards, then
catches up.  Over-invalidation is safe (a dropped entry is re-fetched);
serving under a stale epoch is the bug the property test hunts.

Pure host-plane state: no meter events, no trace events — with one CN
the gate never observes a foreign epoch and the plane is dormant
byte-for-byte.
"""

from __future__ import annotations

import numpy as np


class ShardEpochs:
    """Per-shard write epochs + per-CN seen-epoch vectors.

    ``epoch[s]`` counts multicast invalidations of shard ``s``;
    ``seen[c, s]`` is the newest epoch CN ``c`` has applied to its cache.
    ``seen[c, s] < epoch[s]`` means CN ``c`` may hold stale entries for
    shard ``s`` and must invalidate before serving from cache.
    """

    def __init__(self, n_shards: int, n_cns: int) -> None:
        self.epoch = np.zeros(n_shards, dtype=np.int64)
        self.seen = np.zeros((n_cns, n_shards), dtype=np.int64)
        self.bumps = 0          # shard-epoch increments (writer multicasts)
        self.checks = 0         # gate comparisons (one per stack call)
        self.stale_syncs = 0    # (cn, shard) catch-ups after a mismatch

    @property
    def n_shards(self) -> int:
        return int(self.epoch.shape[0])

    @property
    def n_cns(self) -> int:
        return int(self.seen.shape[0])

    def grow(self, n_shards: int) -> None:
        """Extend to ``n_shards`` (a §4.4 split appended tables).

        New shards start at epoch 0 with every CN current: the split's
        own sync point already invalidated every bound cache, so there
        is nothing stale to chase."""
        extra = int(n_shards) - self.n_shards
        if extra <= 0:
            return
        self.epoch = np.concatenate(
            [self.epoch, np.zeros(extra, dtype=np.int64)])
        self.seen = np.concatenate(
            [self.seen, np.zeros((self.n_cns, extra), dtype=np.int64)],
            axis=1)

    def bump(self, cn: int, shards: np.ndarray) -> int:
        """CN ``cn`` wrote into ``shards`` (unique indices): advance each
        shard's epoch and mark the writer current (its own cache layer
        already observed the mutation).  Returns the bump count."""
        self.epoch[shards] += 1
        self.seen[cn, shards] = self.epoch[shards]
        n = int(len(shards))
        self.bumps += n
        return n

    def stale_shards(self, cn: int, shards: np.ndarray) -> np.ndarray:
        """The unique shard indices among ``shards`` CN ``cn`` is behind
        on (a cache serving them could return a dead value)."""
        self.checks += 1
        behind = self.epoch[shards] > self.seen[cn, shards]
        if not behind.any():
            return np.empty(0, dtype=np.int64)
        return np.unique(np.asarray(shards, dtype=np.int64)[behind])

    def sync(self, cn: int, shards: np.ndarray) -> None:
        """CN ``cn`` invalidated its entries for ``shards``: catch up."""
        self.seen[cn, shards] = self.epoch[shards]
        self.stale_syncs += int(len(shards))


__all__ = ["ShardEpochs"]
