"""Outback's decoupled DMPH index (paper §4), with its state on the device.

One ``OutbackShard`` is the paper's (compute-shard, memory-node) pair, the
port of ``repro.core.outback.OutbackShard``:

* **CN component** (compute-heavy, memory-light): ``LudoCN`` — Othello
  bucket locator + per-bucket seeds (``words_a``/``words_b``/``seeds``),
  device tensors.  The Get-path compute (2 Othello hashes + 2
  candidate-bucket hashes + 1 seeded slot hash) is the ``ludo_lookup``
  kernel.
* **MN component** (memory-heavy, compute-light): the packed slot table
  ``slots_lo``/``slots_hi`` (nb, 4), the latest seeds ``seeds_mn`` and the
  KV heap ``heap_klo/khi/vlo/vhi``, device tensors; the overflow cache,
  served only on the rare Makeup path, stays in host memory.

The batched Get is ``ludo_lookup`` → a gather of the slot words →
``slot_unpack`` → a heap gather → the CN's full-key check, all on the
device.  The protocols follow §4.3 exactly as the reference does, and give
the same answers, MN state and ``CommMeter`` totals for the same inputs:
Get (1 RT; Makeup-Get on mismatch), Insert (free slot / MN re-seed /
overflow cache + cache bit), Update/Delete.  An Insert batch pulls the
rows it touches to the host in one copy, runs the §4.3.2 state machine
there and writes the changes back once; the scalar Get/Update/Delete walks
pull the one bucket they touch in a single copy, and the batched Update
and Delete run their fast lanes on the device and hand the rest to those
walks.

An optional CN-side hot-key cache (``repro_torch.core.cn_cache``) sits in
front of the round trip: pass ``cn_cache=CNKeyCache(budget)`` and Gets
consult it first (a batch probes it on the device and sends only its misses
to the index), while Update/Delete/Insert keep it coherent.
``cn_cache=None`` (the default) is the plain protocol.

Lanes are int32 tensors holding uint32 bit patterns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ludo, slots
from repro_torch.core.hashing import (fingerprint6, i32, i32_int, lanes,
                                      slot_hash, slot_hash_int, split_u64)
from repro_torch.core.meter import MSG_BYTES, CommMeter
from repro_torch.core.othello import Othello
from repro_torch.core.overflow import OverflowCache
from repro_torch.kernels import ops

GET_REQ_BYTES = 8  # ind_bucket + ind_slot, packed (padded to MSG_BYTES on wire)
KV_BLOCK_BYTES = 32  # klen(8)+vlen(8)+key(8)+value(8) — the paper's workloads
_M32 = 0xFFFFFFFF
_CACHE_BIT = 1 << slots.CACHE_SHIFT


class ShardFullError(RuntimeError):
    pass


def resolve_device(device) -> torch.device:
    """``None`` means CUDA, and raises when there is no card: the port runs
    on the CPU only when the caller asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class GetResult:
    value: int | None
    round_trips: int
    makeup: bool


# What one CN-cache answer saves on the wire: a positive hit skips the 1-RT
# Get; a negative hit skips the full 2-RT miss-plus-makeup route.  Shared by
# every cache front (shard, store, the api stack) so the accounting cannot
# diverge.  Both directions of an RPC message are padded to MSG_BYTES
# (paper §5.1), so the saved response is the padded message.
CACHE_HIT_SAVINGS = dict(saved_rts=1, saved_req=MSG_BYTES,
                         saved_resp=MSG_BYTES)
CACHE_NEG_SAVINGS = dict(saved_rts=2, saved_req=2 * MSG_BYTES,
                         saved_resp=2 * MSG_BYTES)


def cached_get(cache, meter, key: int, mn_get):
    """Front a scalar Get with a CN cache: probe, account, fall through to
    ``mn_get(key)`` on a miss and offer the result for admission."""
    state, val = cache.lookup(key)
    if state == "hit":
        meter.add_cache_hit(1, **CACHE_HIT_SAVINGS)
        return GetResult(val, 0, False)
    if state == "neg":
        meter.add_cache_hit(1, neg=True, **CACHE_NEG_SAVINGS)
        return GetResult(None, 0, False)
    res = mn_get(key)
    cache.fill(key, res.value)
    return res


def meter_cache_batch(meter, n_hit: int, n_neg: int) -> None:
    """Account a batched probe's hit/neg lanes (same savings as scalar)."""
    meter.add_cache_hit(n_hit, **CACHE_HIT_SAVINGS)
    meter.add_cache_hit(n_neg, neg=True, **CACHE_NEG_SAVINGS)


class _Bucket:
    """Host copy of one bucket: slot lanes, the heap lanes at each slot's
    address, the MN seed, and any extra values pulled in the same copy."""

    __slots__ = ("lo", "hi", "klo", "khi", "vlo", "vhi", "seed", "extra")

    def __init__(self, h: list[int]):
        self.lo, self.hi = h[0:4], h[4:8]
        self.klo, self.khi = h[8:12], h[12:16]
        self.vlo, self.vhi = h[16:20], h[20:24]
        self.seed = h[24]
        self.extra = h[25:]

    def length(self, t: int) -> int:
        return (self.hi[t] >> slots.LEN_SHIFT) & slots.LEN_MASK

    def holds(self, t: int, lo: int, hi: int) -> bool:
        """Slot ``t`` is occupied and its heap block carries key (lo, hi)."""
        return self.length(t) != 0 and self.klo[t] == lo and self.khi[t] == hi

    def value(self, t: int) -> int:
        return (self.vhi[t] << 32) | self.vlo[t]


class _Row:
    """Host image of one bucket during an insert batch: each slot's words,
    its length and fingerprint (decoded by ``slot_unpack``), the key at its
    heap address, and the bucket's MN seed."""

    __slots__ = ("lo", "hi", "length", "fp", "klo", "khi", "seed")

    def __init__(self, lo, hi, length, fp, klo, khi, seed):
        self.lo, self.hi, self.length, self.fp = lo, hi, length, fp
        self.klo, self.khi, self.seed = klo, khi, seed

    def put(self, t: int, s_lo: int, s_hi: int, length: int, fp: int,
            klo: int, khi: int) -> None:
        self.lo[t], self.hi[t], self.length[t], self.fp[t] = (s_lo, s_hi,
                                                              length, fp)
        self.klo[t], self.khi[t] = klo, khi

    def slot(self, t: int) -> tuple:
        return (self.lo[t], self.hi[t], self.length[t], self.fp[t],
                self.klo[t], self.khi[t])


class _InsertImage:
    """What an insert batch reads and writes, on the host: the rows of the
    buckets it touches, the heap blocks it appends and the values it
    overwrites.  :meth:`OutbackShard._write_back` applies it to the device
    in one scatter per array."""

    def __init__(self, heap_top: int):
        self.rows: dict[int, _Row] = {}
        self.dirty: set[int] = set()  # buckets whose row changed
        self.reseeded: set[int] = set()  # buckets whose seed changed
        self.heap0 = heap_top
        self.blocks: list[list[int]] = []  # [klo, khi, vlo, vhi] from heap0
        self.values: dict[int, tuple[int, int]] = {}  # addr < heap0

    def heap_write(self, lo: int, hi: int, value: int) -> int:
        self.blocks.append([lo, hi, value & _M32, (value >> 32) & _M32])
        return self.heap0 + len(self.blocks) - 1

    def set_value(self, a: int, value: int) -> None:
        v = (value & _M32, (value >> 32) & _M32)
        if a >= self.heap0:
            self.blocks[a - self.heap0][2:] = v
        else:
            self.values[a] = v


def _split(key: int):
    key = int(key)
    return key & _M32, (key >> 32) & _M32


def _pack_int(fp: int, addr: int):
    """The (lo, hi) uint32 words of a fresh slot (cache 0, 32-byte block)."""
    hi = ((fp & slots.FP_MASK) << slots.FP_SHIFT) | (
        KV_BLOCK_BYTES << slots.LEN_SHIFT)
    return addr & _M32, hi


def _last_of_each(x: torch.Tensor) -> torch.Tensor:
    """Index of the last occurrence of each distinct value of ``x``."""
    vals, perm = torch.sort(x, stable=True)
    tail = torch.ones_like(vals, dtype=torch.bool)
    tail[:-1] = vals[:-1] != vals[1:]
    return perm[tail]


def _u32_numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32).copy()


class OutbackShard:
    """One shard: CN view + MN state + the RDMA-RPC protocol between them."""

    def __init__(self, keys: np.ndarray, values: np.ndarray, *,
                 load_factor: float = 0.95, heap_slack: float = 1.30,
                 overflow_frac: float = 0.08, rng_seed: int = 0,
                 num_buckets: int | None = None, oth_ma: int | None = None,
                 oth_mb: int | None = None, heap_cap: int | None = None,
                 cn_cache=None, transport=None, device=None):
        self.device = resolve_device(device)
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        n = int(keys.shape[0])
        lo, hi = (torch.from_numpy(x.astype(np.int64)) for x in split_u64(keys))
        vlo, vhi = (torch.from_numpy(x.astype(np.int64))
                    for x in split_u64(values))
        # the build runs on the host, as in the reference and the paper
        build = ludo.build(lo, hi, load_factor=load_factor, rng_seed=rng_seed,
                           num_buckets=num_buckets, oth_ma=oth_ma,
                           oth_mb=oth_mb)
        self.load_factor = load_factor
        nb = build.cn.num_buckets

        # ---- memory node state, assembled on the host, then moved ----
        if heap_cap is None:
            heap_cap = max(16, int(np.ceil(n * heap_slack)) + 64)
        if n > heap_cap:  # the reference's growth rule, applied up front
            heap_cap = max(n, int(heap_cap * 1.5) + 64)
        heap = torch.zeros((4, heap_cap), dtype=torch.int32)
        heap[0, :n], heap[1, :n] = i32(lo), i32(hi)
        heap[2, :n], heap[3, :n] = i32(vlo), i32(vhi)
        addrs = torch.arange(n, dtype=torch.int64)
        s_lo, s_hi = slots.pack(0, fingerprint6(lo, hi), KV_BLOCK_BYTES,
                                addrs, 0)
        # fallback keys carry a sentinel bucket: mask them out of the
        # scatter — at tiny n they are NOT rare
        ok = torch.ones(n, dtype=torch.bool)
        ok[build.fallback] = False
        slots_lo = torch.zeros((nb, 4), dtype=torch.int32)
        slots_hi = torch.zeros((nb, 4), dtype=torch.int32)
        slots_lo[build.bucket[ok], build.slot[ok]] = s_lo[ok]
        slots_hi[build.bucket[ok], build.slot[ok]] = s_hi[ok]
        self.overflow = OverflowCache(max(64, int(n * overflow_frac)))
        for i in build.fallback.tolist():
            self.overflow.insert(int(lo[i]) & _M32, int(hi[i]) & _M32, i)

        dev = self.device
        self.cn = build.cn.to(dev)  # CN-cached locator + seeds
        self.slots_lo, self.slots_hi = slots_lo.to(dev), slots_hi.to(dev)
        self.seeds_mn = build.cn.seeds.to(dev, copy=True)  # MN's latest seeds
        self.heap_klo, self.heap_khi, self.heap_vlo, self.heap_vhi = (
            heap[j].to(dev, copy=True) for j in range(4))
        self.heap_top = n
        self.meter = CommMeter()
        # optional repro_torch.net.Transport: meter events double as a
        # timed-op trace
        self.meter.sink = transport
        self.frozen = False  # resize in progress: inserts/deletes rejected
        self.cn_cache = cn_cache  # optional CN-side hot-key cache
        self.n_keys = n

    @classmethod
    def from_reference_arrays(cls, cn: dict, mn_state: dict, *, device,
                              load_factor: float = 0.95,
                              transport=None) -> "OutbackShard":
        """A shard that answers exactly as a ``repro`` shard does, built from
        that shard's arrays rather than from keys.

        ``cn`` holds the reference's CN half as numpy: ``words_a``,
        ``words_b``, ``ma``, ``mb``, ``seed_a``, ``seed_b`` (its Othello),
        ``seeds`` and ``num_buckets``; ``mn_state`` is its ``mn_state()``;
        ``transport`` is bound to the new shard's meter."""
        dev = torch.device(device)
        oth = Othello(lanes(cn["words_a"], dev), lanes(cn["words_b"], dev),
                      int(cn["ma"]), int(cn["mb"]), int(cn["seed_a"]),
                      int(cn["seed_b"]))
        seeds = torch.from_numpy(np.array(cn["seeds"], dtype=np.uint8)).to(dev)
        return cls._from_state(ludo.LudoCN(oth, seeds, int(cn["num_buckets"])),
                               mn_state, load_factor=load_factor,
                               transport=transport)

    @classmethod
    def _from_state(cls, cn: ludo.LudoCN, mn_state: dict, *,
                    load_factor: float, transport=None) -> "OutbackShard":
        """A shard from a CN locator (on its device) and an MN image,
        without the constructor's build and without metering."""
        t = cls.__new__(cls)
        t.device = cn.device
        t.load_factor = load_factor
        t.cn = cn
        t.slots_lo = torch.empty(tuple(mn_state["slots_lo"].shape),
                                 dtype=torch.int32, device=t.device)
        t.overflow = OverflowCache(int(mn_state["overflow"]["cap"]))
        t.meter = CommMeter()
        t.meter.sink = transport
        t.cn_cache = None
        t.install_mn_state(mn_state)
        return t

    # ------------------------------------------------------------ device io
    def _lanes(self, a: np.ndarray) -> torch.Tensor:
        return lanes(a, self.device)

    def _pull_bucket(self, b, extra: torch.Tensor | None = None) -> _Bucket:
        """One device->host copy of bucket ``b`` (an int or a 1-element
        index tensor): its slots, the heap lanes they address, its seed."""
        row_lo = self.slots_lo[b].reshape(4)
        row_hi = self.slots_hi[b].reshape(4)
        a = row_lo.long()
        parts = [row_lo, row_hi, self.heap_klo[a], self.heap_khi[a],
                 self.heap_vlo[a], self.heap_vhi[a],
                 self.seeds_mn[b].reshape(1).to(torch.int32)]
        if extra is not None:
            parts.append(extra)
        return _Bucket(torch.cat(parts).cpu().numpy().view(np.uint32).tolist())

    def _locate1(self, lo: int, hi: int):
        """Locate one key on the device and pull its bucket in the same
        copy: returns ``(bucket, slot, _Bucket)``."""
        b_t, s_t = self.cn.locate(
            torch.tensor([i32_int(lo)], dtype=torch.int32, device=self.device),
            torch.tensor([i32_int(hi)], dtype=torch.int32, device=self.device))
        v = self._pull_bucket(b_t.long(), extra=torch.cat([b_t, s_t]))
        return v.extra[0], v.extra[1], v

    def _set_value(self, a: int, value: int) -> None:
        self.heap_vlo[a] = i32_int(value & _M32)
        self.heap_vhi[a] = i32_int((value >> 32) & _M32)

    def _set_slot(self, b: int, s: int, s_lo: int, s_hi: int) -> None:
        self.slots_lo[b, s] = i32_int(s_lo)
        self.slots_hi[b, s] = i32_int(s_hi)

    # ------------------------------------------------------------------ heap
    def _heap_grow(self, need: int) -> None:
        cap = max(need, int(self.heap_klo.shape[0] * 1.5) + 64)
        for name in ("heap_klo", "heap_khi", "heap_vlo", "heap_vhi"):
            old = getattr(self, name)
            new = torch.zeros(cap, dtype=torch.int32, device=self.device)
            new[: old.shape[0]] = old
            setattr(self, name, new)

    # ------------------------------------------------------------- protocols
    def get(self, key: int) -> GetResult:
        """Get: CN cache first (0 RT on a hit), else the §4.3 protocol."""
        if self.cn_cache is None:
            return self._get_mn(key)
        return cached_get(self.cn_cache, self.meter, key, self._get_mn)

    def _get_mn(self, key: int) -> GetResult:
        """Single-op Get, exactly the paper's Fig. 6(a) message sequence."""
        lo, hi = _split(key)
        # CN: locator math (5 hashes), then ONE round trip carrying 8 bytes
        b, s, v = self._locate1(lo, hi)
        # the CN always inspects the returned block (one compare) — counted
        # up front so the scalar walk and ``get_batch`` meter identically
        self.meter.add(rts=1, req=GET_REQ_BYTES, resp=KV_BLOCK_BYTES,
                       cn_hash=5, cn_cmp=1, mn_reads=2)
        # MN: pure dereference — slot, then heap block
        if v.holds(s, lo, hi):
            return GetResult(v.value(s), 1, False)
        return self._makeup_get(lo, hi, b, v)

    def _makeup_get(self, lo: int, hi: int, bucket: int,
                    v: _Bucket) -> GetResult:
        """Makeup Get (ind_slot = -1): MN searches the overflow cache, then
        the bucket's (<=4) blocks; returns the fresh seed if it re-seeded."""
        addr, probes = self.overflow.lookup(lo, hi)
        self.meter.add(rts=1, req=GET_REQ_BYTES + 8, resp=KV_BLOCK_BYTES,
                       mn_hash=1, mn_cmp=probes, mn_reads=probes, cont=True)
        if addr is not None:
            pair = torch.stack([self.heap_vlo[addr], self.heap_vhi[addr]])
            v_lo, v_hi = pair.cpu().numpy().view(np.uint32).tolist()
            return GetResult((v_hi << 32) | v_lo, 2, True)
        for t in range(4):
            if v.length(t) == 0:
                continue
            self.meter.add(0, mn_cmp=1, mn_reads=2, attach=True)
            if v.holds(t, lo, hi):
                # seed changed MN-side; the CN refreshes its copy (§4.3.1)
                self.cn.seeds[bucket] = self.seeds_mn[bucket]
                return GetResult(v.value(t), 2, True)
        return GetResult(None, 2, True)

    def insert(self, key: int, value: int) -> str:
        """Insert per §4.3.2. Returns the resolution case for accounting:
        'slot' | 'reseed' | 'overflow' | 'update' | 'frozen'.  Afterwards
        the key exists, so the CN cache forgets any absence of it."""
        # CN sends ind_bucket + full KV (not ind_slot: MN owns latest seeds)
        return self.insert_batch(np.array([int(key)], dtype=np.uint64),
                                 np.array([int(value)], dtype=np.uint64))[0]

    def _insert_lane(self, img: _InsertImage, lo: int, hi: int, value: int,
                     b: int, s: int | None, fp: int) -> str:
        """The MN half of one Insert, after the CN locate, over the host
        image of bucket ``b``; ``s`` is None when the slot must be hashed
        against a seed that changed earlier in the batch."""
        self.meter.add(rts=1, req=8 + KV_BLOCK_BYTES, resp=8,
                       cn_hash=4, mn_hash=1, mn_writes=1)
        r = img.rows[b]
        # MN: seeded slot with the *latest* seed
        if s is None:
            s = slot_hash_int(lo, hi, r.seed)
        occupied = r.length[s] != 0
        if occupied:
            # fingerprint short-circuit, then full-key compare
            self.meter.add(0, mn_cmp=1, attach=True)
            if r.fp[s] == fp:
                self.meter.add(0, mn_cmp=1, mn_reads=1, attach=True)
                if r.klo[s] == lo and r.khi[s] == hi:
                    # resolves to Update (in place: fixed-size values)
                    img.set_value(r.lo[s], value)
                    return "update"

        # the key may already live in the overflow cache (spilled by an
        # earlier insert, possibly under a since-rotated seed): resolve to
        # Update there, or a re-insert would duplicate it
        addr0, probes = self.overflow.lookup(lo, hi)
        self.meter.add(0, mn_hash=1, mn_cmp=probes, mn_reads=probes,
                       attach=True)
        if addr0 is not None:
            img.set_value(addr0, value)
            self.meter.add(0, mn_writes=1, attach=True)
            return "update"

        addr = img.heap_write(lo, hi, value)
        new = (*_pack_int(fp, addr), KV_BLOCK_BYTES, fp, lo, hi)
        if not occupied:  # case 1: free slot
            r.put(s, *new)
            img.dirty.add(b)
            self.n_keys += 1
            return "slot"

        # case 2: the bucket has a free slot somewhere -> the MN brute-forces
        # a new seed over its keys + the new one, rewrites the bucket and
        # returns the seed to the CN
        occ = [t for t in range(4) if r.length[t] != 0]
        if len(occ) < 4:
            k_lo = [r.klo[t] for t in occ] + [lo]
            k_hi = [r.khi[t] for t in occ] + [hi]
            self.meter.add(0, mn_reads=len(occ), attach=True)
            new_seed = ludo.find_bucket_seed(k_lo, k_hi)
            # account the brute force: ~(tries x keys) hashes on the MN
            self.meter.add(0, mn_hash=(new_seed + 1 if new_seed is not None
                                       else ludo.MAX_SEED) * len(k_lo),
                           attach=True)
            if new_seed is not None:
                moved = [(slot_hash_int(r.klo[t], r.khi[t], new_seed),
                          r.slot(t)) for t in occ]
                for t in range(4):
                    r.put(t, 0, 0, 0, 0, 0, 0)
                for u, old in moved:  # move survivors
                    r.put(u, *old)
                r.put(slot_hash_int(lo, hi, new_seed), *new)
                r.seed = new_seed  # returned to the CN in the RPC response
                img.dirty.add(b)
                img.reseeded.add(b)
                self.n_keys += 1
                return "reseed"

        # case 3: all four slots taken -> overflow cache + cache bit
        ok, probes = self.overflow.insert(lo, hi, addr)
        self.meter.add(0, mn_hash=1, mn_cmp=probes, mn_writes=1, attach=True)
        if not ok:
            raise ShardFullError("overflow cache full: s_stop breached")
        r.hi[s] |= _CACHE_BIT
        img.dirty.add(b)
        self.n_keys += 1
        return "overflow"

    def _write_back(self, img: _InsertImage) -> None:
        """Apply an insert batch's host image to the device: the appended
        heap blocks, the overwritten values, the changed rows and seeds,
        one host->device copy and one scatter per array."""
        dev = self.device
        if img.blocks:
            top = img.heap0 + len(img.blocks)
            cap = self.heap_klo.shape[0]
            while cap < top:  # the growth rule of one write at a time
                cap = max(cap + 1, int(cap * 1.5) + 64)
            if cap != self.heap_klo.shape[0]:
                self._heap_grow(cap)
            blk = lanes(np.array(img.blocks, np.uint32).T, dev)
            for j, name in enumerate(("heap_klo", "heap_khi", "heap_vlo",
                                      "heap_vhi")):
                getattr(self, name)[img.heap0:top] = blk[j]
            self.heap_top = top
        if img.values:
            a = torch.tensor(list(img.values), dtype=torch.int64, device=dev)
            v = lanes(np.array(list(img.values.values()), np.uint32).T, dev)
            self.heap_vlo[a], self.heap_vhi[a] = v[0], v[1]
        if img.dirty:
            bs = sorted(img.dirty)
            rows = lanes(np.array([img.rows[b].lo + img.rows[b].hi
                                   for b in bs], np.uint32), dev)
            idx = torch.tensor(bs, dtype=torch.int64, device=dev)
            self.slots_lo[idx], self.slots_hi[idx] = rows[:, :4], rows[:, 4:]
        if img.reseeded:
            bs = sorted(img.reseeded)
            idx = torch.tensor(bs, dtype=torch.int64, device=dev)
            seeds = torch.tensor([img.rows[b].seed for b in bs],
                                 dtype=torch.uint8, device=dev)
            self.seeds_mn[idx] = seeds
            self.cn.seeds[idx] = seeds

    def update(self, key: int, value: int) -> bool:
        """Update; on success the CN cache entry is refreshed (coherence)."""
        ok = self._update_mn(key, value)
        if ok and self.cn_cache is not None:
            self.cn_cache.note_update(key, value)
        return ok

    def _update_mn(self, key: int, value: int) -> bool:
        """Update per §4.3.3 (1 RT; fp + full-key verify on the MN)."""
        lo, hi = _split(key)
        value = int(value)
        b, s, v = self._locate1(lo, hi)
        self.meter.add(rts=1, req=8 + KV_BLOCK_BYTES, resp=8,
                       cn_hash=5, mn_reads=2, mn_cmp=1)
        if v.holds(s, lo, hi):
            self._set_value(v.lo[s], value)
            self.meter.add(0, mn_writes=1, attach=True)
            return True
        if v.hi[s] >> slots.CACHE_SHIFT:  # redirect to the overflow cache
            addr, probes = self.overflow.lookup(lo, hi)
            self.meter.add(0, mn_hash=1, mn_cmp=probes, mn_reads=probes,
                           attach=True)
            if addr is not None:
                self._set_value(addr, value)
                self.meter.add(0, mn_writes=1, attach=True)
                return True
        # stale CN seed: retry against every slot of the bucket (MN-side)
        for t in range(4):
            if v.length(t) == 0 or t == s:
                continue
            self.meter.add(0, mn_cmp=1, mn_reads=1, attach=True)
            if v.klo[t] == lo and v.khi[t] == hi:
                self._set_value(v.lo[t], value)
                self.meter.add(0, mn_writes=1, attach=True)
                self.cn.seeds[b] = self.seeds_mn[b]
                return True
        return False

    def delete(self, key: int) -> bool:
        """Delete; on success the CN cache entry is dropped (coherence)."""
        ok = self._delete_mn(key)
        if ok and self.cn_cache is not None:
            self.cn_cache.note_delete(key)
        return ok

    def _delete_mn(self, key: int) -> bool:
        """Delete per §4.3.3: mark the slot length zero."""
        if self.frozen:
            return False
        lo, hi = _split(key)
        b, s, v = self._locate1(lo, hi)
        self.meter.add(rts=1, req=8 + 8, resp=8, cn_hash=5,
                       mn_reads=2, mn_cmp=1)
        if v.holds(s, lo, hi):
            self._set_slot(b, s, 0, v.hi[s] & _CACHE_BIT)  # keep cache hint
            self.meter.add(0, mn_writes=1, attach=True)
            self.n_keys -= 1
            return True
        ok, probes = self.overflow.delete(lo, hi)
        self.meter.add(0, mn_hash=1, mn_cmp=probes,
                       mn_writes=1 if ok else 0, attach=True)
        if ok:
            self.n_keys -= 1
        return ok

    # --------------------------------------------------- batched write path
    # The batched mutations are exact vectorisations of the scalar §4.3
    # walks: the CN locate and the MN fast-path classification run on the
    # device over the whole batch, lanes the fast path fully resolves are
    # applied with scatters, and every remaining lane falls through to the
    # scalar walk (which meters itself), in lane order.

    def _locate_batch(self, keys: np.ndarray):
        keys = np.asarray(keys, dtype=np.uint64)
        lo_h, hi_h = split_u64(keys)
        lo, hi = self._lanes(lo_h), self._lanes(hi_h)
        b, s = self.cn.locate(lo, hi)
        return keys, lo, hi, b.long(), s.long()

    def _decode_at(self, b: torch.Tensor, s: torch.Tensor):
        """Gather the slots at (b, s) and decode them with ``slot_unpack``;
        returns ``(s_hi, length, addr)`` with ``addr`` as int64."""
        flat = b * 4 + s
        s_lo = self.slots_lo.view(-1)[flat]
        s_hi = self.slots_hi.view(-1)[flat]
        _, _, length, addr = ops.slot_unpack(s_lo, s_hi)
        return s_hi, length, addr.long()

    def insert_batch(self, keys: np.ndarray, values: np.ndarray) -> list[str]:
        """Batched Insert: one status string per lane (§4.3.2 cases).

        The CN locate, MN slot hash and fingerprints run on the device,
        and the rows of the buckets the batch touches (decoded by
        ``slot_unpack``, with the heap key at each slot's address) come to
        the host in one copy.  The MN state machine then runs per lane over
        that host image, so two lanes in one bucket, or a re-seed moving a
        later lane's slot, resolve exactly as the scalar stream would; the
        image goes back to the device once, at the end of the batch."""
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        n = int(keys.shape[0])
        if n == 0:
            return []
        if self.frozen:
            return ["frozen"] * n
        lo_h, hi_h = split_u64(keys)
        lo, hi = self._lanes(lo_h), self._lanes(hi_h)
        b_vec, _ = self.cn.locate(lo, hi)
        b_vec = b_vec.long()
        seed = self.seeds_mn[b_vec]
        s_vec = slot_hash(lo, hi, seed)
        fp_vec = fingerprint6(lo, hi)
        r_lo = self.slots_lo[b_vec].reshape(-1)
        r_hi = self.slots_hi[b_vec].reshape(-1)
        _, r_fp, r_len, r_addr = ops.slot_unpack(r_lo, r_hi)
        a = r_addr.long()
        host = torch.cat([r_lo, r_hi, r_len, r_fp, self.heap_klo[a],
                          self.heap_khi[a]] + [x.to(torch.int32) for x in (
                              b_vec, seed, s_vec, fp_vec)])
        host = host.cpu().numpy().view(np.uint32)
        rows = host[:24 * n].reshape(6, n, 4).tolist()
        b_h, seed_h, s_h, fp_h = host[24 * n:].reshape(4, n).tolist()
        img = _InsertImage(self.heap_top)
        for i, b in enumerate(b_h):  # the first lane of a bucket brings it
            if b not in img.rows:
                img.rows[b] = _Row(*(f[i] for f in rows), seed_h[i])
        statuses: list[str] = []
        try:
            for i, b in enumerate(b_h):
                # a re-seed earlier in the batch rotated this bucket's seed:
                # the precomputed slot is stale, recompute against it
                s = None if b in img.reseeded else s_h[i]
                statuses.append(self._insert_lane(
                    img, int(lo_h[i]), int(hi_h[i]), int(values[i]), b, s,
                    fp_h[i]))
        finally:
            self._write_back(img)
            if self.cn_cache is not None:  # every lane that completed
                done = len(statuses)
                self.cn_cache.note_insert_batch(keys[:done], values[:done])
        return statuses

    def update_batch(self, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Batched Update (§4.3.3): returns the per-lane success mask.

        Fast lanes (full-key match at the located slot) are one gather + one
        scatter on the device; the rest take the scalar walk unchanged."""
        keys, lo, hi, b, s = self._locate_batch(keys)
        values = np.asarray(values, dtype=np.uint64)
        vlo_h, vhi_h = split_u64(values)
        _, length, addr = self._decode_at(b, s)
        fast = ((length != 0) & (self.heap_klo[addr] == lo)
                & (self.heap_khi[addr] == hi))
        ok = fast.cpu().numpy()
        n_fast = int(ok.sum())
        if n_fast:
            # duplicate keys: the last lane wins, as in lane order
            a = addr[fast]
            last = _last_of_each(a)
            self.heap_vlo[a[last]] = self._lanes(vlo_h)[fast][last]
            self.heap_vhi[a[last]] = self._lanes(vhi_h)[fast][last]
            self.meter.add(n_fast, rts=1, req=8 + KV_BLOCK_BYTES, resp=8,
                           cn_hash=5, mn_reads=2, mn_cmp=1, mn_writes=1)
        ok = ok.copy()
        for i in np.nonzero(~ok)[0]:
            ok[i] = self._update_mn(int(keys[i]), int(values[i]))
        if self.cn_cache is not None:
            self.cn_cache.note_update_batch(keys[ok], values[ok])
        return ok

    def delete_batch(self, keys: np.ndarray) -> np.ndarray:
        """Batched Delete (§4.3.3): returns the per-lane success mask.

        Fast lanes (first occurrence of a slot-resident key) clear their
        slots in one scatter, keeping the cache-hint bit; duplicates and
        non-residents take the scalar walk."""
        if self.frozen:
            return np.zeros(int(np.asarray(keys).shape[0]), dtype=bool)
        keys, lo, hi, b, s = self._locate_batch(keys)
        n = int(keys.shape[0])
        first = np.zeros(n, dtype=bool)
        first[np.unique(keys, return_index=True)[1]] = True
        s_hi, length, addr = self._decode_at(b, s)
        fast = (torch.from_numpy(first).to(self.device) & (length != 0)
                & (self.heap_klo[addr] == lo) & (self.heap_khi[addr] == hi))
        ok = fast.cpu().numpy().copy()
        n_fast = int(ok.sum())
        if n_fast:
            flat = b[fast] * 4 + s[fast]
            self.slots_lo.view(-1)[flat] = 0
            # keep the cache hint (bit 31 of the int32 pattern)
            self.slots_hi.view(-1)[flat] = s_hi[fast] & -_CACHE_BIT
            self.meter.add(n_fast, rts=1, req=8 + 8, resp=8, cn_hash=5,
                           mn_reads=2, mn_cmp=1, mn_writes=1)
            self.n_keys -= n_fast
        for i in np.nonzero(~ok)[0]:
            ok[i] = self._delete_mn(int(keys[i]))
        if self.cn_cache is not None:
            self.cn_cache.note_delete_batch(keys[ok])
        return ok

    # ----------------------------------------------------------- batched Get
    def cn_arrays(self):
        """The CN-cached arrays: the Othello words and the bucket seeds."""
        oth = self.cn.othello
        return oth.words_a, oth.words_b, self.cn.seeds

    def mn_arrays(self):
        return (self.slots_lo, self.slots_hi, self.heap_klo, self.heap_khi,
                self.heap_vlo, self.heap_vhi)

    def get_batch(self, keys: np.ndarray, *,
                  resolve_makeup: bool | None = None):
        """Vectorised Get over a key batch -> (v_lo, v_hi, match) tensors.

        Mismatched lanes (stale CN seeds / overflow residents) are resolved
        by the Makeup-Get when ``resolve_makeup`` is true — the default
        whenever a CN cache is attached, so the cache only ever learns
        resolved truths.

        With a CN cache attached, the batch is probed first on the device:
        hit and known-absent lanes are answered from the cache (no round
        trip is accounted for them), only the misses go through the index
        (a batch that the cache answers whole launches no index kernel),
        and the cache adapts from the whole batch."""
        keys = np.asarray(keys, dtype=np.uint64)
        lo_h, hi_h = split_u64(keys)
        n = int(keys.shape[0])
        if resolve_makeup is None:
            resolve_makeup = self.cn_cache is not None
        if self.cn_cache is None:
            out = outback_get_batch(self._lanes(lo_h), self._lanes(hi_h),
                                    self.cn, self.mn_arrays())
            self.meter.add(n, rts=1, req=GET_REQ_BYTES, resp=KV_BLOCK_BYTES,
                           cn_hash=5, cn_cmp=1, mn_reads=2)
            if resolve_makeup:
                out = self._resolve_makeups(keys, *out)
            return out
        # ---- CN-cache stage: hits never cross the wire ----
        hit, neg, v_lo, v_hi = self.cn_cache.probe_batch(lo_h, hi_h)
        hit_h, neg_h = torch.stack([hit, neg]).cpu().numpy()
        n_hit, n_neg = int(hit_h.sum()), int(neg_h.sum())
        self.meter.add(n - n_hit - n_neg, rts=1, req=GET_REQ_BYTES,
                       resp=KV_BLOCK_BYTES, cn_hash=5, cn_cmp=1, mn_reads=2)
        meter_cache_batch(self.meter, n_hit, n_neg)
        match = hit.clone()
        mi = np.nonzero(~hit_h & ~neg_h)[0]
        if mi.size:  # only the misses touch the MN arrays
            mi_t = torch.from_numpy(mi).to(self.device)
            m_out = outback_get_batch(self._lanes(lo_h[mi]),
                                      self._lanes(hi_h[mi]), self.cn,
                                      self.mn_arrays())
            if resolve_makeup:
                m_out = self._resolve_makeups(keys[mi], *m_out)
            v_lo[mi_t], v_hi[mi_t], match[mi_t] = m_out
        self.cn_cache.observe_batch(lo_h, hi_h, v_lo, v_hi, match, hit_h,
                                    neg_h)
        return v_lo, v_hi, match

    def _resolve_makeups(self, keys: np.ndarray, v_lo, v_hi, match, *,
                         skip=None):
        """Makeup-Get for the mismatched lanes of a batched Get (§4.3.1).

        One CN locate, one batched overflow probe and one (m, 4)
        bucket-slot scan on the device; the accounting stays a per-lane
        loop emitting exactly the scalar ``_makeup_get``'s meter events."""
        pending = ~match
        if skip is not None:
            pending &= ~skip
        idx_t = torch.nonzero(pending).flatten()
        idx = idx_t.cpu().numpy()
        if idx.size == 0:
            return v_lo, v_hi, match
        v_lo, v_hi, match = v_lo.clone(), v_hi.clone(), match.clone()
        m = int(idx.size)
        lo_h, hi_h = split_u64(np.asarray(keys, np.uint64)[idx])
        lo, hi = self._lanes(lo_h), self._lanes(hi_h)
        b, _ = self.cn.locate(lo, hi)
        b = b.long()
        o_addr, o_probes = self.overflow.lookup_batch(lo_h, hi_h)
        o_hit = o_addr >= 0
        # the bucket's (<=4) blocks, scanned only where the overflow missed
        _, _, length, addr = ops.slot_unpack(self.slots_lo[b].reshape(-1),
                                             self.slots_hi[b].reshape(-1))
        s_addr = addr.long().view(m, 4)
        nonempty = length.view(m, 4) != 0
        s_match = (nonempty & (self.heap_klo[s_addr] == lo[:, None])
                   & (self.heap_khi[s_addr] == hi[:, None]))
        four = torch.arange(4, device=self.device)
        first = torch.where(s_match, four, 4).min(dim=1).values
        # the scalar walk skips empty slots silently and stops at the
        # match, so it examines every non-empty slot up to (and incl.) it
        n_exam = (nonempty & (four[None, :] <= first[:, None])).sum(dim=1)
        any_m, n_exam = torch.stack([s_match.any(dim=1).long(),
                                     n_exam]).cpu().numpy()
        any_s = any_m.astype(bool) & ~o_hit
        for t in range(m):
            self.meter.add(rts=1, req=GET_REQ_BYTES + 8, resp=KV_BLOCK_BYTES,
                           mn_hash=1, mn_cmp=int(o_probes[t]),
                           mn_reads=int(o_probes[t]), cont=True)
            if not o_hit[t]:
                for _ in range(int(n_exam[t])):
                    self.meter.add(0, mn_cmp=1, mn_reads=2, attach=True)
        if any_s.any():
            # seed changed MN-side; the CN refreshes its copy (§4.3.1)
            bb = b[torch.from_numpy(any_s).to(self.device)]
            self.cn.seeds[bb] = self.seeds_mn[bb]
        o_hit_t = torch.from_numpy(o_hit).to(self.device)
        lanes_m = torch.arange(m, device=self.device)
        res_addr = torch.where(o_hit_t, torch.from_numpy(o_addr).to(self.device),
                               s_addr[lanes_m, first.clamp(max=3)])
        ok = torch.from_numpy(o_hit | any_s).to(self.device)
        hit_idx, a = idx_t[ok], res_addr[ok]
        v_lo[hit_idx] = self.heap_vlo[a]
        v_hi[hit_idx] = self.heap_vhi[a]
        match[hit_idx] = True
        return v_lo, v_hi, match

    # ---------------------------------------------------------- MN image
    def mn_state(self) -> dict:
        """Host (numpy) image of the MN half, in the reference's layout and
        dtypes: what a rejoining replica re-installs."""
        return {"slots_lo": _u32_numpy(self.slots_lo),
                "slots_hi": _u32_numpy(self.slots_hi),
                "seeds_mn": self.seeds_mn.cpu().numpy().copy(),
                "heap_klo": _u32_numpy(self.heap_klo),
                "heap_khi": _u32_numpy(self.heap_khi),
                "heap_vlo": _u32_numpy(self.heap_vlo),
                "heap_vhi": _u32_numpy(self.heap_vhi),
                "heap_top": self.heap_top,
                "overflow": self.overflow.state(),
                "n_keys": self.n_keys,
                "frozen": self.frozen}

    def install_mn_state(self, state: dict) -> None:
        """Overwrite this shard's MN half with an :meth:`mn_state` image (of
        this package or of ``repro``).  Bucket counts must match."""
        if tuple(state["slots_lo"].shape) != tuple(self.slots_lo.shape):
            raise ValueError("bucket-count mismatch: replicas must be built "
                             "from the same spec")

        def dev(name):
            a = np.array(state[name], dtype=np.uint32)
            return torch.from_numpy(a.view(np.int32)).to(self.device)

        self.slots_lo, self.slots_hi = dev("slots_lo"), dev("slots_hi")
        self.seeds_mn = torch.from_numpy(
            np.array(state["seeds_mn"], dtype=np.uint8)).to(self.device)
        self.heap_klo, self.heap_khi = dev("heap_klo"), dev("heap_khi")
        self.heap_vlo, self.heap_vhi = dev("heap_vlo"), dev("heap_vhi")
        self.heap_top = int(state["heap_top"])
        self.overflow.install(state["overflow"])
        self.n_keys = int(state["n_keys"])
        self.frozen = bool(state["frozen"])

    def mn_state_bytes(self) -> int:
        """On-wire size of one MN image (live heap prefix only)."""
        return int(self.slots_lo.numel() * 8 + self.seeds_mn.numel()
                   + self.heap_top * 16 + self.overflow.state_bytes())

    # ------------------------------------------------------------ accounting
    def cn_memory_bytes(self) -> int:
        return self.cn.memory_bytes()

    def mn_index_bytes(self) -> int:
        return (self.slots_lo.numel() * 8 + self.seeds_mn.numel()
                + self.overflow.cap * 12)

    def dmph_load(self) -> float:
        return self.n_keys / (self.cn.num_buckets * 4)

    def needs_resize(self) -> bool:
        """The paper's s_slow trigger: DMPH load 97% or overflow half full."""
        return self.dmph_load() >= 0.97 or self.overflow.fill_ratio >= 0.5

    def must_stop(self) -> bool:
        """The paper's s_stop trigger: overflow cache over 90% full."""
        return self.overflow.fill_ratio >= 0.9

    def live_pairs(self):
        """All live (keys, values) as host uint64 arrays."""
        st = self.mn_state()
        lens = (st["slots_hi"] >> np.uint32(slots.LEN_SHIFT)) & np.uint32(
            slots.LEN_MASK)
        b_idx, s_idx = np.nonzero(lens != 0)
        addrs = st["slots_lo"][b_idx, s_idx].astype(np.int64)
        _, _, o_addr = self.overflow.items()
        addrs = np.concatenate([addrs, o_addr.astype(np.int64)])
        keys = (st["heap_khi"][addrs].astype(np.uint64) << np.uint64(32)) | \
            st["heap_klo"][addrs].astype(np.uint64)
        vals = (st["heap_vhi"][addrs].astype(np.uint64) << np.uint64(32)) | \
            st["heap_vlo"][addrs].astype(np.uint64)
        return keys, vals


def outback_get_batch(lo, hi, cn: ludo.LudoCN, mn):
    """The core of the batched Get: CN locate, then the MN's two dependent
    gathers and zero compute, then the CN's full-key check.  ``lo``/``hi``
    are int32 lanes on the device of ``cn`` and ``mn``."""
    slots_lo, slots_hi, h_klo, h_khi, h_vlo, h_vhi = mn
    # ---- CN compute: the ludo_lookup kernel ----
    bucket, slot = cn.locate(lo, hi)
    # ---- one round trip; MN side: slot gather, decode, heap gather ----
    flat = bucket.long() * 4 + slot.long()
    _, _, length, addr = ops.slot_unpack(slots_lo.view(-1)[flat],
                                         slots_hi.view(-1)[flat])
    a = addr.long()
    v_lo, v_hi = h_vlo[a], h_vhi[a]
    # ---- CN full-key check ----
    match = (h_klo[a] == lo) & (h_khi[a] == hi) & (length != 0)
    return v_lo, v_hi, match
