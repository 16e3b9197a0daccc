"""Session-state parking backed by the Outback KVS, read through the CN cache.

The port of ``repro.serve.session_store``.  The serving engine parks paused
conversations' recurrent state as opaque blobs.  Here the blob travels
through the paper's index: it is chunked into 8-byte words, each stored
under a derived 64-bit key via the Insert protocol, and read back with the
batched Get.  The blob's bytes, the chunk keys and values, the meters and
the MN images are those of the reference for the same parks.

The store is opened through the ``repro_torch.api`` registry — one
``StoreSpec('outback-dir', cache_budget_bytes=..., batch=...)`` on
``device`` (CUDA unless the caller passes ``"cpu"``) — so reads go through
the stack's CN-side hot-key cache layer (a conversation that bounces
between park and resume stops paying MN round trips for its state after
the first resume).

Parks ride the submission plane: ``put`` *submits* its Insert batch and
returns without flushing, so bursts of parks coalesce under the store's
``BatchPolicy`` window into one doorbell ring.  The policy's strict
ordering makes this safe — a resume (``get``) of a still-pending session
is a read-after-write hazard on the chunk keys, which flushes the queue
before the read crosses the wire, and re-parks of the same session
coalesce in submission order.

Key derivation: ``splitmix64(SALT ^ (rid << 20) + index)`` — index 0 holds
the blob's byte length, indices 1.. hold the data words.  A blob of
``_MAX_CHUNKS`` words or more is refused, as in the reference.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api import BatchPolicy, StoreSpec, open_store
from repro_torch.core.hashing import splitmix64
from repro_torch.core.store import make_uniform_keys

_SALT = 0x5E551047_0B5E55ED
_MAX_CHUNKS = 1 << 20


class KVSessionStore:
    """Park/resume blobs in an Outback directory store: reads served via
    the ``repro_torch.api`` stack's CN cache layer, parks coalesced by the
    store's ``BatchPolicy``."""

    def __init__(self, *, cn_cache_budget_bytes: int = 64 << 10,
                 bootstrap_keys: int = 4096, load_factor: float = 0.85,
                 rng_seed: int = 0, batch_window: int = 2048,
                 transport=None, device=None):
        # The store needs a non-empty build set; runtime Inserts grow it
        # (and exercise the §4.4 resize path once sessions pile up).
        # ``transport`` (a repro_torch.net.Transport) puts every
        # park/resume Insert/Get on the simulated RDMA clock.
        # ``batch_window=1`` restores the synchronous per-park behaviour.
        boot = make_uniform_keys(bootstrap_keys, seed=rng_seed + 97)
        self.spec = StoreSpec("outback-dir", load_factor=load_factor,
                              rng_seed=rng_seed,
                              cache_budget_bytes=cn_cache_budget_bytes,
                              batch=BatchPolicy(window=batch_window,
                                                order="strict"))
        self.store = open_store(self.spec, boot, splitmix64(boot),
                                transport=transport, device=device)
        self._lengths: dict[int, int] = {}  # rid -> n_words (for delete)

    @staticmethod
    def _chunk_keys(rid: int, n: int) -> np.ndarray:
        base = np.uint64(_SALT) ^ (np.uint64(rid) << np.uint64(20))
        return splitmix64(base + np.arange(n, dtype=np.uint64))

    # ----------------------------------------------------------------- api
    def put(self, rid: int, blob: bytes) -> int:
        """Park ``blob`` under ``rid``; returns the number of KV inserts.

        Submits without flushing: the Insert lanes ride the store's
        ``BatchPolicy`` window and hit the wire at the next doorbell
        (window-full, an explicit ``flush``, or a hazarding read).
        """
        pad = (-len(blob)) % 8
        words = np.frombuffer(blob + b"\0" * pad, dtype="<u8")
        if words.size >= _MAX_CHUNKS:
            raise ValueError("session blob too large")
        old = self._lengths.get(rid)
        if old is not None and old > words.size:
            # shrinking re-park: reclaim the tail chunks the overwrite below
            # will not touch, or they leak in the store forever
            tail = self._chunk_keys(rid, old + 1)[words.size + 1:]
            self.store.submit("delete", tail)
        ks = self._chunk_keys(rid, words.size + 1)
        vals = np.concatenate([np.uint64([len(blob)]),
                               words.astype(np.uint64)])
        self.store.submit("insert", ks, vals)
        self._lengths[rid] = words.size
        return words.size + 1

    def get(self, rid: int) -> bytes | None:
        """Fetch ``rid``'s blob (batched Get through the CN cache layer).

        A still-pending park of this session is a read-after-write hazard:
        the pipeline flushes it before either Get crosses the wire."""
        head = self.store.get(int(self._chunk_keys(rid, 1)[0]))
        if head.value is None:
            return None
        nbytes = int(head.value)
        n_words = (nbytes + 7) // 8
        if n_words == 0:
            return b""
        ks = self._chunk_keys(rid, n_words + 1)[1:]
        res = self.store.get_batch(ks)
        if not res.found.all():
            return None  # torn blob (concurrent delete)
        return res.values.astype("<u8").tobytes()[:nbytes]

    def delete(self, rid: int) -> bool:
        n = self._lengths.pop(rid, None)
        if n is None:
            return False
        self.store.submit("delete", self._chunk_keys(rid, n + 1))
        return True

    def flush(self) -> None:
        """Force every pending park/delete onto the wire."""
        self.store.flush()

    # ---------------------------------------------------------- accounting
    @property
    def cache_stats(self):
        return self.store.cache.stats

    def meter_total(self):
        self.store.flush()  # pending parks are not on the wire yet
        return self.store.meter_totals()


__all__ = ["KVSessionStore"]
