"""The memory-node overflow cache (paper §4.2/§4.3.2).

Holds (key -> heap address) pairs that could not be placed in the DMPH table
without re-seeding more than one bucket or resizing.  The paper uses a plain
hash table here — served by the MN *only* on the rare Makeup-Get path, so its
compute cost is accounted to the memory node.

An open-addressing (linear probing) table in flat arrays, the port of
``repro.core.overflow`` with the same probe sequence and counts.  It stays
in host memory: the MN serves it only on the rare Makeup-Get path, and the
protocol walks over it are scalar.  ``lookup_batch`` hashes through the
port's torch hashing.  Capacity is sized from the DMPH table; the two
resize thresholds (s_slow / s_stop) are evaluated against it by
``OutbackShard``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import hash_range, hash_range_int


class OverflowCache:
    _PROBE_LIMIT = 512

    def __init__(self, capacity: int):
        capacity = max(8, int(capacity))
        self.cap = capacity
        self.k_lo = np.zeros(capacity, dtype=np.uint32)
        self.k_hi = np.zeros(capacity, dtype=np.uint32)
        self.addr = np.zeros(capacity, dtype=np.uint32)
        self.used = np.zeros(capacity, dtype=bool)
        self.size = 0
        self._seed = 0x0F10C

    # -- host protocol ops (memory-node side) --------------------------------
    def _probe(self, lo: int, hi: int):
        """Yield probe positions; returns (pos_of_key | None, first_free | None)."""
        h = hash_range_int(int(lo), int(hi), self._seed, self.cap)
        free = None
        for i in range(self._PROBE_LIMIT):
            p = (h + i) % self.cap
            if not self.used[p]:
                if free is None:
                    free = p
                return None, free, i + 1
            if int(self.k_lo[p]) == lo and int(self.k_hi[p]) == hi:
                return p, free, i + 1
        return None, free, self._PROBE_LIMIT

    def insert(self, lo: int, hi: int, addr: int) -> tuple[bool, int]:
        pos, free, probes = self._probe(lo, hi)
        if pos is not None:  # overwrite
            self.addr[pos] = addr
            return True, probes
        if free is None:
            return False, probes
        self.k_lo[free], self.k_hi[free] = lo, hi
        self.addr[free] = addr
        self.used[free] = True
        self.size += 1
        return True, probes

    def lookup(self, lo: int, hi: int) -> tuple[int | None, int]:
        pos, _, probes = self._probe(lo, hi)
        return (int(self.addr[pos]) if pos is not None else None), probes

    def lookup_batch(self, lo: np.ndarray, hi: np.ndarray):
        """Vectorised ``lookup`` over many keys at once.

        Returns ``(addr, probes)``: int64 heap addresses (-1 where the key
        is absent) and the exact per-lane probe count the scalar walk
        would report — probing advances one step for *all* unresolved
        lanes per iteration, so the loop runs max-probes times instead of
        lanes × probes Python iterations.  Element-wise identical to
        ``lookup`` (tested), so the batched Makeup-Get meters the same.
        """
        lo = np.asarray(lo, dtype=np.uint32)
        hi = np.asarray(hi, dtype=np.uint32)
        n = int(lo.shape[0])
        h = hash_range(torch.from_numpy(lo.astype(np.int64)),
                       torch.from_numpy(hi.astype(np.int64)), self._seed,
                       self.cap).numpy()
        addr = np.full(n, -1, dtype=np.int64)
        probes = np.zeros(n, dtype=np.int64)
        active = np.ones(n, dtype=bool)
        for i in range(self._PROBE_LIMIT):
            idx = np.nonzero(active)[0]
            if idx.size == 0:
                break
            p = (h[idx] + i) % self.cap
            used = self.used[p]
            match = used & (self.k_lo[p] == lo[idx]) & (self.k_hi[p] == hi[idx])
            probes[idx] += 1
            addr[idx[match]] = self.addr[p[match]]
            active[idx[match | ~used]] = False
        return addr, probes

    def delete(self, lo: int, hi: int) -> tuple[bool, int]:
        pos, _, probes = self._probe(lo, hi)
        if pos is None:
            return False, probes
        # Backward-shift deletion to keep linear probing correct.
        self.used[pos] = False
        self.size -= 1
        nxt = (pos + 1) % self.cap
        while self.used[nxt]:
            lo2, hi2 = int(self.k_lo[nxt]), int(self.k_hi[nxt])
            home = hash_range_int(lo2, hi2, self._seed, self.cap)
            if _between(home, pos, nxt, self.cap):
                self.k_lo[pos], self.k_hi[pos] = self.k_lo[nxt], self.k_hi[nxt]
                self.addr[pos] = self.addr[nxt]
                self.used[pos] = True
                self.used[nxt] = False
                pos = nxt
            nxt = (nxt + 1) % self.cap
        return True, probes

    def items(self):
        idx = np.nonzero(self.used)[0]
        return self.k_lo[idx], self.k_hi[idx], self.addr[idx]

    # -- MN image (mn_state / install_mn_state) -------------------------------
    def state(self) -> dict:
        """Deep-copied memory image, installable via :meth:`install`."""
        return {"k_lo": self.k_lo.copy(), "k_hi": self.k_hi.copy(),
                "addr": self.addr.copy(), "used": self.used.copy(),
                "size": self.size, "cap": self.cap}

    def install(self, state: dict) -> None:
        """Overwrite this cache with another replica's :meth:`state`."""
        if int(state["cap"]) != self.cap:
            raise ValueError("overflow capacity mismatch: replicas must be "
                             "built from the same spec")
        self.k_lo[:] = state["k_lo"]
        self.k_hi[:] = state["k_hi"]
        self.addr[:] = state["addr"]
        self.used[:] = state["used"]
        self.size = int(state["size"])

    def state_bytes(self) -> int:
        """On-wire size of one replica image (resync-cost accounting)."""
        return int(self.k_lo.nbytes + self.k_hi.nbytes + self.addr.nbytes
                   + self.used.nbytes)

    @property
    def fill_ratio(self) -> float:
        return self.size / self.cap


def _between(home: int, pos: int, cur: int, cap: int) -> bool:
    """True if ``home`` is in the (cyclic) range (cur, pos] — i.e. the entry at
    ``cur`` may legally move back to ``pos``."""
    if pos <= cur:
        return home <= pos or home > cur
    return pos >= home > cur
