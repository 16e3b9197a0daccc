"""Ludo-paged KV cache: the paper's decoupled index as a page table.

The port of ``repro.cache.paged``.  The serving-side analogue of Outback:

* **CN component**: the Ludo locator over page keys
  ``key = (seq_id << 24) | logical_page``, a few bits a page, on the card.
* **MN component**: the DMPH slot table holding physical page ids, plus the
  page pool itself.  A decode-step lookup is one batched Get on the device
  (the ``ludo_lookup`` and ``slot_unpack`` kernels, then two gathers), so
  the page map lies on the card before ``ops.paged_attention`` launches,
  and the kernel reads it there.

``CuckooPageTable`` is the probing baseline (RACE analogue): two candidate
buckets per key, a reader must inspect both, and
``ops.cuckoo_paged_attention`` fetches both candidate pages.  Its table
stays on the host, as in the reference; its page maps go to the device.

Three properties of the reference hold here bit for bit: the index is
seeded with ``capacity_pages // 8`` sentinel keys and has no resize path,
so ``append_page`` raises ``ShardFullError`` once the overflow cache is
full (about 36% of ``capacity_pages`` appended in order);
``lookup_batch`` runs the Get without the Makeup-Get, so a page that lives
in the overflow cache comes back unmatched, with another heap value in its
page-map entry; and the cuckoo table's missing candidate is page 0.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import hash_range_int
from repro_torch.core.outback import OutbackShard, resolve_device
from repro_torch.core.store import make_uniform_keys

_M32 = 0xFFFFFFFF


def page_key(seq_id, logical):
    return (np.uint64(seq_id) << np.uint64(24)) | np.uint64(logical)


class PageAllocator:
    def __init__(self, num_pages: int):
        self.free = list(range(num_pages - 1, -1, -1))
        self.num_pages = num_pages

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("KV page pool exhausted")
        return self.free.pop()

    def release(self, page: int) -> None:
        self.free.append(page)

    @property
    def used(self) -> int:
        return self.num_pages - len(self.free)


class LudoPageTable:
    """(seq, logical_page) -> physical page through the Outback index.

    Built over sentinel keys; allocations use the paper's Insert protocol
    (free slot / reseed / overflow) and sequence teardown uses Delete, both
    through the shard's scalar walks.  ``lookup_batch`` is the decode-step
    path: one batched Get whose page map stays on the device."""

    def __init__(self, capacity_pages: int, *, load_factor: float = 0.85,
                 device=None):
        # seed the table with reserved sentinel keys so the DMPH structure
        # exists before the first real page lands
        seed_n = max(64, capacity_pages // 8)
        keys = make_uniform_keys(seed_n, seed=0xFA6E) | (
            np.uint64(1) << np.uint64(63))
        self.shard = OutbackShard(keys, np.zeros(seed_n, np.uint64),
                                  load_factor=load_factor,
                                  num_buckets=max(
                                      1, int(capacity_pages / (4 * load_factor))),
                                  device=device)
        self.allocator = PageAllocator(capacity_pages)
        self._live: dict[int, list[int]] = {}  # seq -> phys pages (teardown)

    @classmethod
    def from_reference(cls, cn: dict, mn_state: dict, free: list, live: dict,
                       *, device, capacity_pages: int | None = None
                       ) -> "LudoPageTable":
        """A table that answers exactly as a ``repro`` table does, read from
        that table's state: ``cn`` and ``mn_state`` as for
        ``OutbackShard.from_reference_arrays``, ``free`` its allocator's free
        list and ``live`` its map of each sequence to its physical pages.
        ``capacity_pages`` is the pool size, by default the free and live
        pages together; pass it for a table whose append raised
        ``ShardFullError``, since that append's page is in neither."""
        t = cls.__new__(cls)
        t.shard = OutbackShard.from_reference_arrays(cn, mn_state,
                                                     device=device)
        live = {int(s): [int(p) for p in ps] for s, ps in live.items()}
        if capacity_pages is None:
            capacity_pages = len(free) + sum(len(p) for p in live.values())
        t.allocator = PageAllocator(capacity_pages)
        t.allocator.free = [int(p) for p in free]
        t._live = live
        return t

    @property
    def device(self) -> torch.device:
        return self.shard.device

    def append_page(self, seq_id: int, logical: int) -> int:
        phys = self.allocator.alloc()
        k = int(page_key(seq_id, logical))
        self.shard.insert(k, phys)
        self._live.setdefault(seq_id, []).append(phys)
        return phys

    def lookup(self, seq_id: int, logical: int) -> int | None:
        r = self.shard.get(int(page_key(seq_id, logical)))
        return None if r.value is None else int(r.value)

    def lookup_batch(self, seq_id: int, num_pages: int):
        """Page map for one sequence, the decode-step fast path: ``(page_map,
        match)``, an int32 and a bool tensor on the table's device."""
        keys = page_key(seq_id, np.arange(num_pages, dtype=np.uint64))
        v_lo, _, match = self.shard.get_batch(keys)
        return v_lo, match

    def release_sequence(self, seq_id: int) -> int:
        pages = self._live.pop(seq_id, [])
        for i, phys in enumerate(pages):
            self.shard.delete(int(page_key(seq_id, i)))
            self.allocator.release(phys)
        return len(pages)

    def cn_bits_per_page(self) -> float:
        return self.shard.cn_memory_bytes() * 8 / self.allocator.num_pages


class CuckooPageTable:
    """2-choice probing baseline: each key lands in one of two candidate
    buckets of 4 slots with an 8-bit fingerprint; a reader must inspect both
    candidates (the paged-attention baseline fetches both pages).  The table
    is host numpy, as in the reference; page maps go to ``device``."""

    SLOTS = 4

    def __init__(self, capacity_pages: int, *, load_factor: float = 0.7,
                 device=None):
        self.device = resolve_device(device)
        nb = max(2, int(np.ceil(capacity_pages / (self.SLOTS * load_factor))))
        self.nb = nb
        self.fp = np.zeros((nb, self.SLOTS), np.uint8)
        self.val = np.full((nb, self.SLOTS), -1, np.int64)
        self.key = np.zeros((nb, self.SLOTS), np.uint64)
        self.allocator = PageAllocator(capacity_pages)
        self._live: dict[int, list[int]] = {}

    def _cands(self, k: int):
        lo, hi = k & _M32, (k >> 32) & _M32
        b0 = hash_range_int(lo, hi, 0xCC0, self.nb)
        b1 = hash_range_int(lo, hi, 0xCC1, self.nb)
        fp = hash_range_int(lo, hi, 0xCCF, 255) + 1
        return b0, b1, fp

    def append_page(self, seq_id: int, logical: int) -> int:
        phys = self.allocator.alloc()
        k = int(page_key(seq_id, logical))
        b0, b1, fp = self._cands(k)
        for b in (b0, b1):
            free = np.nonzero(self.val[b] < 0)[0]
            if free.size:
                s = free[0]
                self.fp[b, s] = fp
                self.val[b, s] = phys
                self.key[b, s] = k
                self._live.setdefault(seq_id, []).append(phys)
                return phys
        raise RuntimeError("cuckoo page table full (no eviction path)")

    def lookup2(self, seq_id: int, logical: int):
        """Returns ((cand0, cand1), select): a reader must fetch both."""
        k = int(page_key(seq_id, logical))
        b0, b1, fp = self._cands(k)
        cands, sel = [], 0
        for ci, b in enumerate((b0, b1)):
            hit = np.nonzero((self.fp[b] == fp) & (self.val[b] >= 0)
                             & (self.key[b] == np.uint64(k)))[0]
            if hit.size:
                cands.append(int(self.val[b, hit[0]]))
                sel = ci
            else:
                cands.append(0)
        return (cands[0], cands[1]), sel

    def lookup2_batch(self, seq_id: int, num_pages: int):
        """``(page_map2, select)``: int32 tensors of shapes (L, 2) and (L,)
        on the table's device."""
        pm2 = np.zeros((num_pages, 2), np.int32)
        sel = np.zeros((num_pages,), np.int32)
        for i in range(num_pages):
            (c0, c1), s = self.lookup2(seq_id, i)
            pm2[i] = (c0, c1)
            sel[i] = s
        return (torch.from_numpy(pm2).to(self.device),
                torch.from_numpy(sel).to(self.device))

    def release_sequence(self, seq_id: int) -> int:
        pages = self._live.pop(seq_id, [])
        for i in range(len(pages)):
            k = page_key(seq_id, i)
            b0, b1, fp = self._cands(int(k))
            for b in (b0, b1):
                hit = np.nonzero(self.key[b] == k)[0]
                if hit.size:
                    self.val[b, hit[0]] = -1
                    self.key[b, hit[0]] = 0
        for phys in pages:
            self.allocator.release(phys)
        return len(pages)

    def table_bits_per_page(self) -> float:
        return (self.fp.nbytes + self.val.nbytes + self.key.nbytes) * 8 \
            / self.allocator.num_pages
