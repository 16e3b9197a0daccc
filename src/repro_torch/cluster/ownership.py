"""``repro_torch.cluster.ownership`` — shard -> owning-CN table with
minimal-move rebalance (the port of ``repro.cluster.ownership``: the same
seeded rendezvous hash, so the same shards land on the same CNs).

DINOMO's elasticity insight (PAPERS.md): partition *ownership* of the
index, not the data.  The MN pool holds every shard's slots + heap; each
CN owns the compute-heavy CN half (DMPH seeds + othello arrays) of just
its shards.  On a membership change only the shards whose owner changed
move — O(shards moved), never O(keys) — and the move is a bulk one-sided
READ of the CN half, exactly the §4.4 locator-fetch shape the resize
path already meters.

Placement is highest-random-weight (rendezvous) hashing over the live
set, seeded by the membership schedule: deterministic, coordination-free
(every CN computes the same table), and minimal — a join steals ~S/N
shards from the others; a leave scatters only the leaver's shards.
FlexKV's framing motivates keeping this a per-shard property so later
adaptive placement can override single entries without a new mechanism.
"""

from __future__ import annotations

import numpy as np

from repro_torch.net.faults import _mix64


class OwnershipTable:
    """Mutable shard->CN map; one per :class:`repro_torch.cluster.Cluster`.

    ``owners[s]`` is the CN currently owning directory table ``s``.
    §4.4 splits extend it (:meth:`extend_for_split` — the successor
    inherits the parent's owner, keeping the move local); membership
    changes rebalance it (:meth:`rebalance` — returns exactly the moved
    shards so the caller can meter the handoff).

    ``fence[s]`` is the shard's **fencing token** (DINOMO / PAPERS.md):
    a monotone epoch bumped every time the shard's owner changes.  A CN
    routing from a stale snapshot of this table presents stale tokens;
    the write path compares them against the live tokens before touching
    MN state and rejects mismatches (``fenced_writes``), so a partition
    survivor and a healed stale owner can never both mutate a shard.
    """

    def __init__(self, n_shards: int, live, seed: int = 0) -> None:
        self.seed = int(seed)
        self.live = tuple(sorted(int(c) for c in live))
        if not self.live:
            raise ValueError("ownership needs at least one live CN")
        self.owners = [self._hrw(s, self.live) for s in range(n_shards)]
        self.fence = [0] * n_shards

    def _hrw(self, shard: int, live: tuple) -> int:
        """Rendezvous winner: the live CN with the highest seeded weight."""
        return max(live, key=lambda c: _mix64(self.seed, shard, c))

    # ------------------------------------------------------------ queries
    def __len__(self) -> int:
        return len(self.owners)

    def owner(self, shard: int) -> int:
        return self.owners[shard]

    def owners_for(self, shards: np.ndarray) -> np.ndarray:
        """Vectorised lookup: shard indices -> owning CN ids."""
        return np.asarray(self.owners, dtype=np.int64)[shards]

    def shards_owned(self, cn: int) -> list:
        return [s for s, o in enumerate(self.owners) if o == cn]

    # ------------------------------------------------------------ updates
    def extend_for_split(self, parent: int) -> None:
        """A §4.4 split appended a successor table: it inherits the
        parent's owner (the split rebuilt both halves at that CN, so no
        cross-CN bytes move) and the parent's fencing token (a snapshot
        current on the parent is current on the child)."""
        self.owners.append(self.owners[parent])
        self.fence.append(self.fence[parent])

    def rebalance(self, new_live) -> list:
        """Recompute every owner over ``new_live``; returns the moves.

        Each move is ``(shard, old_owner, new_owner)``.  Rendezvous
        hashing guarantees minimality: shards whose winner survives the
        membership change never move.
        """
        new_live = tuple(sorted(int(c) for c in new_live))
        if not new_live:
            raise ValueError("cannot rebalance onto an empty live set")
        moved = []
        for s, old in enumerate(self.owners):
            new = self._hrw(s, new_live)
            if new != old:
                moved.append((s, old, new))
                self.owners[s] = new
                self.fence[s] += 1   # new owner => stale snapshots fence
        self.live = new_live
        return moved

    def snapshot(self) -> tuple:
        """Freeze (owners, fence) — what a partitioned CN keeps routing
        from until its first post-heal write is fenced and re-synced."""
        return (list(self.owners), list(self.fence))


__all__ = ["OwnershipTable"]
