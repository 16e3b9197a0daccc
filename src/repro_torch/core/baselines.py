"""The paper's comparison systems (§5.1), with their tables on the device.

The port of ``repro.core.baselines``.  All four share the KV heap layout
with Outback, so differences come only from the *index* and its
communication schedule:

* ``RaceKVS``   — RACE hashing [66]: one-sided RDMA.  Get = 2 round trips
  (read both candidate bucket groups, then read the KV block); zero MN
  compute; the CN does the fingerprint selection and the full-key check.
* ``MicaKVS``   — RPC-MICA [20, 29]: two-sided linear probing over 8-slot
  buckets with 8-bit fingerprints; the MN scans a window of buckets.
* ``ClusterKVS`` — RPC-Cluster hashing [11]: two-sided, 4-way buckets
  chained through indirect buckets, 14-bit fingerprints; the MN walks the
  chain.
* ``DummyKVS``  — RPC-Dummy (§3): the MN answers with one fixed memory
  read, the upper bound for any RDMA-RPC system.

Where the state lives:

* **Host images** (``fp``, ``addr``, Cluster's ``nxt`` and the heap
  ``h_klo``/``h_khi``/``h_vlo``/``h_vhi``, numpy) carry the offline build
  and every mutation.  The build and the mutation walks are the
  reference's, key for key and lane by lane, with the same meter calls in
  the same order (MICA's ``_walk_batch`` and Cluster's
  ``_chain_find_batch`` precomputes included, with their stale-walk rule).
* **Device arrays** (``mn_arrays()``) mirror the images: ``fp`` (uint8 for
  RACE and MICA, int32 for Cluster's 14 bits), ``addr`` and ``nxt`` as
  int32 with the ``-1``/``-2`` sentinels, the heap as int32 bit patterns.
  A mutating call writes the rows it changed back once per array at its
  end, in a ``finally`` (so a lane that raises leaves the card equal to
  the host image), and a grown heap (1.5x + 64) is reallocated there too.
* **Batched Gets** hash the batch on the host (numpy, as the reference's
  numpy path does), move it to the card in one copy, and run the MN scan
  (``mn_get_batch``) and the CN selection as torch ops there.  The
  reference's batch approximations are kept exactly: RACE and MICA verify
  at most the first 3 fingerprint candidates, MICA scans a fixed
  ``SCAN_BUCKETS`` window (a far-displaced build key misses in a batch
  but hits in ``get``), Cluster verifies the first fingerprint hit of at
  most ``MAX_CHAIN`` buckets.  A lane that matches nothing returns heap
  entry 0's value with ``match`` false, as the reference does.

``device=None`` means CUDA and raises without a card; the tests pass
``device="cpu"``.  ``from_reference`` builds an engine from a reference
engine's arrays without running the build, for lockstep tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.hashing import (hash64_32_int, hash64_32_np,
                                      hash_range_int, split_u64)
from repro_torch.core.meter import CommMeter
from repro_torch.core.outback import resolve_device

_FP8_SEED = 0x0F0F8
_FP14_SEED = 0x0F14E
_M32 = 0xFFFFFFFF
_HEAP = ("h_klo", "h_khi", "h_vlo", "h_vhi")
_CHUNK = 1 << 16  # keys a build loop takes from numpy at a time


def _hash_range_np(lo, hi, seed: int, size: int) -> np.ndarray:
    return hash64_32_np(lo, hi, seed) % np.uint32(size)


def _split(key: int) -> tuple[int, int]:
    key = int(key)
    return key & _M32, (key >> 32) & _M32


def _chunks(n: int, *arrays):
    """The build loops' inputs as Python lists, ``_CHUNK`` keys at a time."""
    for c0 in range(0, n, _CHUNK):
        yield c0, [a[c0:c0 + _CHUNK].tolist() for a in arrays]


def _synced(fn):
    """A mutating call: its changed rows reach the device when it ends,
    also when a lane raises."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._sync()
    return run


def _query(dev, *cols) -> tuple[torch.Tensor, ...]:
    """Host uint32/int columns of a batch -> int32 device rows, one copy."""
    q = np.stack([np.asarray(c).astype(np.uint32).view(np.int32)
                  for c in cols])
    return torch.from_numpy(q).to(dev).unbind(0)


def _first_verified(cand, addrs, lo, hi, klo, khi, limit=None):
    """The reference's CN/MN selection over ``(B, L)`` candidate lanes:
    the first candidate whose heap key equals ``(lo, hi)``, trying at most
    the first ``limit`` candidates (all when ``None``).  Returns the heap
    address (0 where none verified) and the match mask."""
    if limit is not None:
        # the first ``limit`` candidate lanes, in lane order: the only
        # ones whose heap keys are read
        rank = torch.arange(cand.shape[1], 0, -1, dtype=torch.int32,
                            device=cand.device)
        first = torch.where(cand, rank, 0).topk(limit, dim=1)
        cand = first.values > 0
        addrs = addrs.gather(1, first.indices)
    a = addrs.clamp(min=0).long()
    ver = cand & (klo[a] == lo[:, None]) & (khi[a] == hi[:, None])
    pos = torch.argmax(ver.to(torch.uint8), 1, keepdim=True)  # first lane
    match = ver.any(1)
    best = torch.where(match, addrs.gather(1, pos).squeeze(1), 0).long()
    return best, match


class _HeapMixin:
    """The KV heap (host image + device mirror) and the row bookkeeping
    that keeps the device arrays equal to the host images."""

    # (host attribute, device attribute) of the index arrays, by row
    _ROW_ARRAYS: tuple = ()
    _INDEX_DTYPES = {"fp": np.uint8, "addr": np.int32, "nxt": np.int32}
    _SIZES: tuple = ()  # the reference engine's size attributes

    def _init_heap(self, keys: np.ndarray, values: np.ndarray) -> None:
        lo, hi = split_u64(keys)
        vlo, vhi = split_u64(values)
        self.h_klo, self.h_khi, self.h_vlo, self.h_vhi = lo, hi, vlo, vhi
        self.heap_top = int(keys.shape[0])
        self.n_keys = int(keys.shape[0])

    def _init_device(self, device, transport) -> None:
        """Move the host images to ``device``; start the meter."""
        self.device = dev = torch.device(device)
        for name in _HEAP:
            setattr(self, "t" + name[1:],
                    torch.from_numpy(getattr(self, name).view(np.int32))
                    .to(dev, copy=True))
        for host, attr in self._ROW_ARRAYS:
            setattr(self, attr,
                    torch.from_numpy(getattr(self, host)).to(dev, copy=True))
        self._rows: set[int] = set()
        self._heap_keys: set[int] = set()
        self._heap_vals: set[int] = set()
        self.meter = CommMeter()
        self.meter.sink = transport

    # ------------------------------------------------------------ host heap
    def _heap_append(self, lo: int, hi: int, vlo: int, vhi: int) -> int:
        """Append one KV block (runtime Insert path); grows amortised."""
        if self.heap_top >= self.h_klo.shape[0]:
            cap = int(self.h_klo.shape[0] * 1.5) + 64
            for name in _HEAP:
                old = getattr(self, name)
                new = np.zeros(cap, dtype=old.dtype)
                new[: old.shape[0]] = old
                setattr(self, name, new)
        a = self.heap_top
        self.h_klo[a], self.h_khi[a] = lo, hi
        self.h_vlo[a], self.h_vhi[a] = vlo, vhi
        self.heap_top += 1
        self._heap_keys.add(a)
        self._heap_vals.add(a)
        return a

    def _heap_set_value(self, addr: int, value: int) -> None:
        self.h_vlo[addr] = value & _M32
        self.h_vhi[addr] = (value >> 32) & _M32
        self._heap_vals.add(int(addr))

    def _verify_and_read(self, addr: int, lo: int, hi: int):
        if addr < 0:
            return None
        if int(self.h_klo[addr]) == lo and int(self.h_khi[addr]) == hi:
            return (int(self.h_vhi[addr]) << 32) | int(self.h_vlo[addr])
        return None

    # ------------------------------------------------------- device mirror
    def _sync(self) -> None:
        """Write the rows changed since the last sync to the device: once
        per array, after reallocating a heap that grew on the host."""
        dev = self.device
        cap = self.h_klo.shape[0]
        if self.t_klo.shape[0] != cap:
            for name in _HEAP:
                old = getattr(self, "t" + name[1:])
                new = torch.zeros(cap, dtype=torch.int32, device=dev)
                new[: old.shape[0]] = old
                setattr(self, "t" + name[1:], new)
        for rows, names in ((self._rows, self._ROW_ARRAYS),
                            (self._heap_keys, (("h_klo", "t_klo"),
                                               ("h_khi", "t_khi"))),
                            (self._heap_vals, (("h_vlo", "t_vlo"),
                                               ("h_vhi", "t_vhi")))):
            if not rows:
                continue
            r = np.fromiter(rows, dtype=np.int64, count=len(rows))
            rows.clear()
            r_t = torch.from_numpy(r).to(dev)
            for host, attr in names:
                src = getattr(self, host)[r]
                if src.dtype == np.uint32:
                    src = src.view(np.int32)
                getattr(self, attr)[r_t] = torch.from_numpy(src).to(dev)

    def host_image(self) -> dict[str, np.ndarray]:
        """The host arrays the device mirrors, by device attribute name."""
        out = {"t" + n[1:]: getattr(self, n).view(np.int32) for n in _HEAP}
        for host, attr in self._ROW_ARRAYS:
            out[attr] = getattr(self, host)
        return out

    def device_image(self) -> dict[str, np.ndarray]:
        """The device arrays copied back, keyed as :meth:`host_image`."""
        return {k: getattr(self, k).cpu().numpy() for k in self.host_image()}

    @classmethod
    def from_reference(cls, kvs, *, device=None, transport=None):
        """The same engine as the reference engine ``kvs`` — its heap,
        heap top and key count, its index arrays and sizes — without
        running the build, for lockstep tests; the meter starts at 0."""
        t = cls.__new__(cls)
        for name in _HEAP:
            setattr(t, name, np.array(getattr(kvs, name), dtype=np.uint32))
        for name in ("heap_top", "n_keys") + cls._SIZES:
            setattr(t, name, int(getattr(kvs, name)))
        for host, _ in cls._ROW_ARRAYS:
            setattr(t, host, np.array(getattr(kvs, host),
                                      dtype=cls._INDEX_DTYPES[host]))
        t._init_device(resolve_device(device), transport)
        return t


class RaceKVS(_HeapMixin):
    """One-sided baseline.  Index: 2-choice bucket groups of 8 slots, 8-bit
    fingerprints; the whole group is fetched per READ (64 B payload).

    All traffic is one-sided RDMA READ payloads, so meter events carry
    ``one_sided=True``: no RPC message padding, and the transport simulator
    routes them through the RNIC read engine instead of the MN CPU."""

    GROUP_SLOTS = 8
    GROUP_BYTES = 8 * 8  # 8 slots x 8 B (fp + addr packed)
    _ROW_ARRAYS = (("fp", "t_fp"), ("addr", "t_addr"))
    _SIZES = ("ng",)

    def __init__(self, keys: np.ndarray, values: np.ndarray, *,
                 load_factor: float = 0.7, rng_seed: int = 0, transport=None,
                 device=None):
        device = resolve_device(device)
        keys = np.asarray(keys, dtype=np.uint64)
        n = keys.shape[0]
        self._init_heap(keys, values)
        ng = max(2, int(np.ceil(n / (self.GROUP_SLOTS * load_factor))))
        self.ng = ng
        lo, hi = split_u64(keys)
        g0 = _hash_range_np(lo, hi, 0xACE0, ng)
        g1 = _hash_range_np(lo, hi, 0xACE1, ng)
        fill = [0] * ng
        grp = np.empty(n, dtype=np.int64)
        slot = np.empty(n, dtype=np.int64)
        for c0, (a_l, b_l) in _chunks(n, g0, g1):
            gs, ss = [], []
            for a, b in zip(a_l, b_l):  # offline: plain 2-choice placement
                g = a if fill[a] <= fill[b] else b
                if fill[g] >= 8:
                    g = b if g == a else a
                    if fill[g] >= 8:
                        raise RuntimeError("RACE table full; lower load "
                                           "factor")
                gs.append(g)
                ss.append(fill[g])
                fill[g] += 1
            grp[c0:c0 + len(gs)] = gs
            slot[c0:c0 + len(ss)] = ss
        self.fp = np.zeros((ng, self.GROUP_SLOTS), dtype=np.uint8)
        self.addr = np.full((ng, self.GROUP_SLOTS), -1, dtype=np.int32)
        self.fp[grp, slot] = self._fp(lo, hi)
        self.addr[grp, slot] = np.arange(n, dtype=np.int32)
        self._init_device(device, transport)

    @staticmethod
    def _fp(lo, hi) -> np.ndarray:
        return (hash64_32_np(lo, hi, _FP8_SEED) & np.uint32(0xFF)) \
            .astype(np.uint8)

    @staticmethod
    def _fp_int(lo: int, hi: int) -> int:
        return hash64_32_int(lo, hi, _FP8_SEED) & 0xFF

    def get(self, key: int):
        lo, hi = _split(key)
        g0 = hash_range_int(lo, hi, 0xACE0, self.ng)
        g1 = hash_range_int(lo, hi, 0xACE1, self.ng)
        fp = self._fp_int(lo, hi)
        # RT 1: read both candidate groups (doorbell-batched one-sided READs).
        self.meter.add(rts=1, req=16, resp=2 * self.GROUP_BYTES,
                       cn_hash=3, mn_reads=0, one_sided=True)
        val = None
        cand = [(g, s) for g in (g0, g1) for s in range(self.GROUP_SLOTS)
                if self.addr[g, s] >= 0 and int(self.fp[g, s]) == fp]
        self.meter.add(0, cn_cmp=2 * self.GROUP_SLOTS, attach=True)
        # RT 2 (+ extra on fp false positives): read the KV block, verify.
        for g, s in cand:
            self.meter.add(0, rts=1, req=16, resp=32, cn_cmp=1,
                           one_sided=True, attach=True)
            val = self._verify_and_read(int(self.addr[g, s]), lo, hi)
            if val is not None:
                break
        if not cand:
            self.meter.add(0, rts=1, req=16, resp=32,
                           one_sided=True, attach=True)  # miss still pays RT2
        return val

    def mn_arrays(self) -> tuple:
        """The device arrays ``get_batch``'s ``arrays=`` takes."""
        return (self.t_fp, self.t_addr, self.t_klo, self.t_khi, self.t_vlo,
                self.t_vhi)

    def get_batch(self, keys: np.ndarray, arrays=None):
        """Batched Get -> ``(v_lo, v_hi, match)`` device tensors (int32 bit
        patterns, bool): both groups gathered, then the CN selection over
        the 16 fetched slots (at most 3 fingerprint candidates verified)."""
        keys = np.asarray(keys, dtype=np.uint64)
        if arrays is None:
            arrays = self.mn_arrays()
        out = self.cn_select(*self.query(keys, arrays[0].device), arrays)
        self.meter.add(int(keys.shape[0]), rts=2, req=32,
                       resp=2 * self.GROUP_BYTES + 32, one_sided=True,
                       cn_hash=3, cn_cmp=2 * self.GROUP_SLOTS + 1)
        return out

    def query(self, keys: np.ndarray, device=None) -> tuple:
        """A batch's CN-side hashes, taken on the host and moved in one
        copy: ``(lo, hi, g0, g1, fp)`` int32 tensors for
        :meth:`cn_select`."""
        lo, hi = split_u64(np.asarray(keys, dtype=np.uint64))
        return _query(self.device if device is None else device, lo, hi,
                      _hash_range_np(lo, hi, 0xACE0, self.ng),
                      _hash_range_np(lo, hi, 0xACE1, self.ng),
                      self._fp(lo, hi))

    def cn_select(self, lo, hi, g0, g1, fp, arrays):
        """The device work of a batched Get (RACE has no MN compute): read
        both candidate groups, then the CN's selection over the 16 fetched
        slots.  Fingerprint false positives cost an extra KV-block read
        (RACE pays an extra RT there)."""
        fp_t, addr_t, klo, khi, vlo, vhi = arrays
        g = torch.stack([g0, g1], 1).long()
        n = int(lo.shape[0])
        fps = fp_t[g].reshape(n, 2 * self.GROUP_SLOTS)
        addrs = addr_t[g].reshape(n, 2 * self.GROUP_SLOTS)
        best, match = _first_verified((fps == fp[:, None]) & (addrs >= 0),
                                      addrs, lo, hi, klo, khi, limit=3)
        return vlo[best], vhi[best], match

    def mn_get_batch(self, bucket, fp, lo, hi, arrays):
        """Uniform MN-side surface (same signature as the RPC baselines).

        RACE is one-sided: the memory node never runs index code — all
        selection happens CN-side after raw READs — so there is no MN
        kernel to time."""
        raise NotImplementedError("RACE is one-sided: no MN compute to time")

    # ------------------------------------------------------ mutations
    # One-sided write path: RT 1 reads both candidate groups (the CN must
    # learn the current layout), RT 2 writes the KV block + slot via RDMA
    # WRITE/CAS.  Accounting mirrors ``get``: raw READ/WRITE payloads, no
    # RPC padding, zero MN compute.
    def _find_entry(self, lo: int, hi: int, g0: int, g1: int, fp: int):
        for g in (g0, g1):
            for s in range(self.GROUP_SLOTS):
                if self.addr[g, s] >= 0 and int(self.fp[g, s]) == fp:
                    a = int(self.addr[g, s])
                    if int(self.h_klo[a]) == lo and int(self.h_khi[a]) == hi:
                        return g, s
        return None

    def _locate_groups(self, key: int):
        lo, hi = _split(key)
        return (lo, hi, hash_range_int(lo, hi, 0xACE0, self.ng),
                hash_range_int(lo, hi, 0xACE1, self.ng), self._fp_int(lo, hi))

    def _locate_groups_batch(self, keys: np.ndarray):
        """Vectorised CN locate for a key batch (the per-op hash work)."""
        keys = np.asarray(keys, dtype=np.uint64)
        lo, hi = split_u64(keys)
        g0 = _hash_range_np(lo, hi, 0xACE0, self.ng).astype(np.int64)
        g1 = _hash_range_np(lo, hi, 0xACE1, self.ng).astype(np.int64)
        return lo, hi, g0, g1, self._fp(lo, hi)

    @_synced
    def insert_batch(self, keys, values) -> list[str]:
        lo, hi, g0, g1, fp = self._locate_groups_batch(keys)
        return [self._insert_at(int(lo[i]), int(hi[i]), int(g0[i]),
                                int(g1[i]), int(fp[i]), int(v))
                for i, v in enumerate(np.asarray(values, dtype=np.uint64))]

    @_synced
    def update_batch(self, keys, values) -> np.ndarray:
        lo, hi, g0, g1, fp = self._locate_groups_batch(keys)
        values = np.asarray(values, dtype=np.uint64)
        return np.asarray([self._update_at(int(lo[i]), int(hi[i]),
                                           int(g0[i]), int(g1[i]),
                                           int(fp[i]), int(values[i]))
                           for i in range(len(values))], dtype=bool)

    @_synced
    def delete_batch(self, keys) -> np.ndarray:
        lo, hi, g0, g1, fp = self._locate_groups_batch(keys)
        return np.asarray([self._delete_at(int(lo[i]), int(hi[i]),
                                           int(g0[i]), int(g1[i]),
                                           int(fp[i]))
                           for i in range(lo.shape[0])], dtype=bool)

    @_synced
    def insert(self, key: int, value: int) -> str:
        return self._insert_at(*self._locate_groups(key), int(value))

    def _insert_at(self, lo, hi, g0, g1, fp, value) -> str:
        self.meter.add(rts=2, req=16 + 8 + 32, resp=2 * self.GROUP_BYTES + 8,
                       one_sided=True, cn_hash=3, cn_cmp=2 * self.GROUP_SLOTS)
        hit = self._find_entry(lo, hi, g0, g1, fp)
        if hit is not None:
            self._heap_set_value(int(self.addr[hit]), value)
            return "update"
        # fp-candidate bound: the batched CN selection verifies at most 3
        # fingerprint candidates across both groups — reject an insert the
        # batched path could never reach behind existing collisions
        same_fp = sum(int(((self.fp[g] == fp) & (self.addr[g] >= 0)).sum())
                      for g in {g0, g1})
        if same_fp >= 3:
            raise RuntimeError("RACE fp-candidate bound: 3+ colliding "
                               "fingerprints in the candidate groups")
        fills = [int((self.addr[g] >= 0).sum()) for g in (g0, g1)]
        order = (g0, g1) if fills[0] <= fills[1] else (g1, g0)
        for g in order:  # pick the slot before touching the heap, so a
            free = np.nonzero(self.addr[g] < 0)[0]  # full table leaves
            if free.size:  # no orphan block behind
                s = int(free[0])
                addr = self._heap_append(lo, hi, value & _M32,
                                         (value >> 32) & _M32)
                self.fp[g, s] = fp
                self.addr[g, s] = addr
                self._rows.add(g)
                self.n_keys += 1
                return "slot"
        raise RuntimeError("RACE: both candidate groups full; lower load "
                           "factor")

    @_synced
    def update(self, key: int, value: int) -> bool:
        return self._update_at(*self._locate_groups(key), int(value))

    def _update_at(self, lo, hi, g0, g1, fp, value) -> bool:
        self.meter.add(rts=2, req=16 + 8 + 32, resp=2 * self.GROUP_BYTES + 8,
                       one_sided=True, cn_hash=3, cn_cmp=2 * self.GROUP_SLOTS)
        hit = self._find_entry(lo, hi, g0, g1, fp)
        if hit is None:
            return False
        self._heap_set_value(int(self.addr[hit]), value)
        return True

    @_synced
    def delete(self, key: int) -> bool:
        return self._delete_at(*self._locate_groups(key))

    def _delete_at(self, lo, hi, g0, g1, fp) -> bool:
        self.meter.add(rts=2, req=16 + 8, resp=2 * self.GROUP_BYTES + 8,
                       one_sided=True, cn_hash=3, cn_cmp=2 * self.GROUP_SLOTS)
        hit = self._find_entry(lo, hi, g0, g1, fp)
        if hit is None:
            return False
        self.addr[hit] = -1
        self._rows.add(hit[0])
        self.n_keys -= 1
        return True

    def index_bytes(self) -> int:
        """Bytes of the device index arrays (int32 ``addr``)."""
        return self.t_fp.nbytes + self.t_addr.nbytes


class MicaKVS(_HeapMixin):
    """Two-sided hopscotch/linear-probing baseline (RPC-MICA).

    Insert walks forward from the home bucket to the first bucket with a
    free lane; Delete leaves a tombstone (``_TOMB``) so the probing
    invariant holds: a query may stop at the first bucket containing a
    *never-used* lane (``_EMPTY``), while tombstoned lanes keep the walk
    going and are reused by later Inserts.  The batched MN scan covers a
    fixed window of ``SCAN_BUCKETS`` buckets.  Runtime Inserts respect that
    window as a displacement bound (reject rather than place a key the scan
    could not see); the offline build keeps its whole-table walk, so a few
    far-displaced build keys remain scalar-only — the reference's
    approximation."""

    BUCKET_SLOTS = 8
    SCAN_BUCKETS = 4  # batched-MN scan window
    _EMPTY = -1  # never-used lane: probing may stop at this bucket
    _TOMB = -2  # deleted lane: reusable, but the walk must continue
    _ROW_ARRAYS = (("fp", "t_fp"), ("addr", "t_addr"))
    _SIZES = ("nb",)

    def __init__(self, keys: np.ndarray, values: np.ndarray, *,
                 load_factor: float = 0.7, rng_seed: int = 0, transport=None,
                 device=None):
        device = resolve_device(device)
        keys = np.asarray(keys, dtype=np.uint64)
        n = keys.shape[0]
        self._init_heap(keys, values)
        nbk = max(2, int(np.ceil(n / (self.BUCKET_SLOTS * load_factor))))
        self.nb = nbk
        lo, hi = split_u64(keys)
        b = _hash_range_np(lo, hi, 0x111CA, nbk)
        fill = [0] * nbk
        grp = np.empty(n, dtype=np.int64)
        slot = np.empty(n, dtype=np.int64)
        for c0, (b_l,) in _chunks(n, b):
            gs, ss = [], []
            for g in b_l:
                for _ in range(nbk):
                    if fill[g] < 8:
                        gs.append(g)
                        ss.append(fill[g])
                        fill[g] += 1
                        break
                    g = (g + 1) % nbk
                else:
                    raise RuntimeError("MICA table full")
            grp[c0:c0 + len(gs)] = gs
            slot[c0:c0 + len(ss)] = ss
        self.fp = np.zeros((nbk, self.BUCKET_SLOTS), dtype=np.uint8)
        self.addr = np.full((nbk, self.BUCKET_SLOTS), -1, dtype=np.int32)
        self.fp[grp, slot] = RaceKVS._fp(lo, hi)
        self.addr[grp, slot] = np.arange(n, dtype=np.int32)
        self._init_device(device, transport)

    def _home(self, key: int):
        lo, hi = _split(key)
        return (lo, hi, hash_range_int(lo, hi, 0x111CA, self.nb),
                RaceKVS._fp_int(lo, hi))

    def get(self, key: int):
        lo, hi, g, fp = self._home(key)
        self.meter.add(rts=1, req=16, resp=32, cn_hash=2)
        for _ in range(self.nb):  # MN probing walk
            self.meter.add(0, mn_reads=1, mn_cmp=self.BUCKET_SLOTS,
                           attach=True)
            full = True
            for s in range(self.BUCKET_SLOTS):
                a = int(self.addr[g, s])
                if a == self._EMPTY:
                    full = False
                    continue
                if a == self._TOMB:
                    continue  # deleted lane: keep probing past it
                if int(self.fp[g, s]) == fp:
                    self.meter.add(0, mn_reads=1, mn_cmp=1, attach=True)
                    val = self._verify_and_read(a, lo, hi)
                    if val is not None:
                        return val
            if not full:
                return None  # linear-probing early termination
            g = (g + 1) % self.nb
        return None

    # ------------------------------------------------------ mutations
    # Two-sided RPC mutations: the CN sends bucket + fingerprint + KV block,
    # the MN walks the probe sequence exactly as ``get`` does.  Accounting
    # mirrors the Get RPC shape (padded messages, MN-side walk costs).
    def _walk_for(self, lo: int, hi: int, fp: int, g: int):
        """(bucket, slot) of the key, first reusable lane (plus how many
        buckets out it sits), buckets walked."""
        free = None
        free_dist = 0
        walked = 0
        for _ in range(self.nb):
            walked += 1
            has_empty = False
            for s in range(self.BUCKET_SLOTS):
                a = int(self.addr[g, s])
                if a == self._EMPTY:
                    has_empty = True
                    if free is None:
                        free, free_dist = (g, s), walked
                    continue
                if a == self._TOMB:
                    if free is None:
                        free, free_dist = (g, s), walked
                    continue
                if (int(self.fp[g, s]) == fp and int(self.h_klo[a]) == lo
                        and int(self.h_khi[a]) == hi):
                    return (g, s), free, free_dist, walked
            if has_empty:
                return None, free, free_dist, walked  # key can't live further
            g = (g + 1) % self.nb
        return None, free, free_dist, walked

    def _home_batch(self, keys: np.ndarray):
        """Vectorised home bucket + fingerprint for a key batch."""
        keys = np.asarray(keys, dtype=np.uint64)
        lo, hi = split_u64(keys)
        g = _hash_range_np(lo, hi, 0x111CA, self.nb).astype(np.int64)
        return lo, hi, g, RaceKVS._fp(lo, hi)

    def _walk_batch(self, lo, hi, g, fp):
        """Vectorised fixed-window probe walks for a mutation batch, on the
        host images: the reference's ``_walk_batch`` exactly.  Returns
        ``(walks, window_buckets)``: per-lane ``_walk_for`` tuples, with
        ``None`` for residual lanes whose walk leaves the window (they
        recompute scalar), plus the ``(n, W)`` window bucket ids for the
        caller's mutation-overlap checks."""
        n = int(lo.shape[0])
        W, S = self.SCAN_BUCKETS, self.BUCKET_SLOTS
        rows = np.arange(n)
        bucks = (g[:, None] + np.arange(W)[None, :]) % self.nb  # (n, W)
        addrs = self.addr[bucks]                                # (n, W, S)
        flat_a = addrs.reshape(n, W * S)
        flat_f = self.fp[bucks].reshape(n, W * S)
        cand = (flat_a >= 0) & (flat_f == np.asarray(fp)[:, None])
        ac = np.clip(flat_a, 0, None)
        verified = cand & (self.h_klo[ac] == lo[:, None]) \
            & (self.h_khi[ac] == hi[:, None])
        found_pos = np.argmax(verified, axis=1)
        has_found = verified[rows, found_pos]
        found_b = found_pos // S
        empty_b = (addrs == self._EMPTY).any(axis=2)            # (n, W)
        stop_b = np.argmax(empty_b, axis=1)
        has_stop = empty_b[rows, stop_b]
        found_ok = has_found & (~has_stop | (found_b <= stop_b))
        resolved = found_ok | has_stop
        # free-lane search ends at the hit (exclusive) or covers the
        # whole stop bucket — the slots the scalar walk actually scanned
        end_pos = np.where(found_ok, found_pos, (stop_b + 1) * S)
        freeable = (flat_a < 0) & (np.arange(W * S)[None, :]
                                   < end_pos[:, None])
        free_pos = np.argmax(freeable, axis=1)
        has_free = freeable[rows, free_pos]
        walks = []
        for i in range(n):
            if not resolved[i]:
                walks.append(None)
                continue
            fnd = ((int(bucks[i, found_b[i]]), int(found_pos[i] % S))
                   if found_ok[i] else None)
            fr, fdist = None, 0
            if has_free[i]:
                fr = (int(bucks[i, free_pos[i] // S]),
                      int(free_pos[i] % S))
                fdist = int(free_pos[i] // S) + 1
            wk = int(found_b[i]) + 1 if found_ok[i] else int(stop_b[i]) + 1
            walks.append((fnd, fr, fdist, wk))
        return walks, bucks

    @_synced
    def insert_batch(self, keys, values) -> list[str]:
        lo, hi, g, fp = self._home_batch(keys)
        values = np.asarray(values, dtype=np.uint64)
        walks, bucks = self._walk_batch(lo, hi, g, fp)
        out = []
        mutated: set[int] = set()  # buckets structurally changed so far
        dirty_all = False          # an untracked (scalar-path) mutation
        for i in range(len(values)):
            w = walks[i]
            if dirty_all or (mutated
                             and not mutated.isdisjoint(bucks[i].tolist())):
                w = None  # stale precompute: rewalk scalar (what the
                #           scalar loop would have seen at this point)
            ret = self._insert_at(int(lo[i]), int(hi[i]), int(g[i]),
                                  int(fp[i]), int(values[i]), walk=w)
            if ret == "slot":  # consumed a free lane: structural change
                if w is not None:
                    mutated.add(w[1][0])
                else:
                    dirty_all = True
            out.append(ret)
        return out

    @_synced
    def update_batch(self, keys, values) -> np.ndarray:
        lo, hi, g, fp = self._home_batch(keys)
        values = np.asarray(values, dtype=np.uint64)
        # updates touch heap values only — never fp/addr structure or heap
        # keys — so precomputed walks cannot go stale mid-batch
        walks, _ = self._walk_batch(lo, hi, g, fp)
        return np.asarray([self._update_at(int(lo[i]), int(hi[i]), int(g[i]),
                                           int(fp[i]), int(values[i]),
                                           walk=walks[i])
                           for i in range(len(values))], dtype=bool)

    @_synced
    def delete_batch(self, keys) -> np.ndarray:
        lo, hi, g, fp = self._home_batch(keys)
        walks, bucks = self._walk_batch(lo, hi, g, fp)
        out = np.zeros(lo.shape[0], dtype=bool)
        mutated: set[int] = set()
        dirty_all = False
        for i in range(lo.shape[0]):
            w = walks[i]
            if dirty_all or (mutated
                             and not mutated.isdisjoint(bucks[i].tolist())):
                w = None
            ok = self._delete_at(int(lo[i]), int(hi[i]), int(g[i]),
                                 int(fp[i]), walk=w)
            if ok:  # tombstoned a lane: structural change
                if w is not None:
                    mutated.add(w[0][0])
                else:
                    dirty_all = True
            out[i] = ok
        return out

    @_synced
    def insert(self, key: int, value: int) -> str:
        """Runtime Insert, bounded by the batched scan's reach: a new key
        may only land within ``SCAN_BUCKETS`` buckets of home, so a key
        `insert` accepts is always visible to `get_batch`."""
        return self._insert_at(*self._home(key), int(value))

    def _insert_at(self, lo, hi, g, fp, value, walk=None) -> str:
        found, free, free_dist, walked = \
            self._walk_for(lo, hi, fp, g) if walk is None else walk
        self.meter.add(rts=1, req=16 + 32, resp=8, cn_hash=2, mn_reads=walked,
                       mn_cmp=walked * self.BUCKET_SLOTS, mn_writes=1)
        if found is not None:
            self._heap_set_value(int(self.addr[found]), value)
            return "update"
        if free is None or free_dist > self.SCAN_BUCKETS:
            raise RuntimeError(
                "MICA displacement bound: no free lane within the "
                f"{self.SCAN_BUCKETS}-bucket scan window")
        # fp-candidate bound: the batched scan verifies at most 3
        # fingerprint candidates per window — an insert queued behind 3+
        # existing collisions would be batch-invisible, so reject it
        window = [(g + d) % self.nb for d in range(self.SCAN_BUCKETS)]
        same_fp = sum(int(((self.fp[w] == fp) & (self.addr[w] >= 0)).sum())
                      for w in window)
        if same_fp >= 3:
            raise RuntimeError("MICA fp-candidate bound: 3+ colliding "
                               "fingerprints in the scan window")
        addr = self._heap_append(lo, hi, value & _M32, (value >> 32) & _M32)
        self.fp[free] = fp
        self.addr[free] = addr
        self._rows.add(free[0])
        self.n_keys += 1
        return "slot"

    @_synced
    def update(self, key: int, value: int) -> bool:
        return self._update_at(*self._home(key), int(value))

    def _update_at(self, lo, hi, g, fp, value, walk=None) -> bool:
        found, _, _, walked = \
            self._walk_for(lo, hi, fp, g) if walk is None else walk
        self.meter.add(rts=1, req=16 + 32, resp=8, cn_hash=2, mn_reads=walked,
                       mn_cmp=walked * self.BUCKET_SLOTS,
                       mn_writes=1 if found else 0)
        if found is None:
            return False
        self._heap_set_value(int(self.addr[found]), value)
        return True

    @_synced
    def delete(self, key: int) -> bool:
        return self._delete_at(*self._home(key))

    def _delete_at(self, lo, hi, g, fp, walk=None) -> bool:
        found, _, _, walked = \
            self._walk_for(lo, hi, fp, g) if walk is None else walk
        self.meter.add(rts=1, req=16, resp=8, cn_hash=2, mn_reads=walked,
                       mn_cmp=walked * self.BUCKET_SLOTS,
                       mn_writes=1 if found else 0)
        if found is None:
            return False
        self.fp[found] = 0
        self.addr[found] = self._TOMB
        self._rows.add(found[0])
        self.n_keys -= 1
        return True

    def mn_arrays(self) -> tuple:
        """The device arrays ``mn_get_batch``'s ``arrays`` take."""
        return (self.t_fp, self.t_addr, self.t_klo, self.t_khi, self.t_vlo,
                self.t_vhi)

    def mn_get_batch(self, bucket, fp, lo, hi, arrays):
        """The isolated MN work per request batch (what one MN thread
        runs), on the arrays' device: scan the ``SCAN_BUCKETS``-bucket
        window from ``bucket`` and verify the first 3 fingerprint hits."""
        fp_t, addr_t, klo, khi, vlo, vhi = arrays
        n = int(bucket.shape[0])
        window = torch.arange(self.SCAN_BUCKETS, device=bucket.device)
        bucks = (bucket.long()[:, None] + window) % self.nb
        fps = fp_t[bucks].reshape(n, self.SCAN_BUCKETS * self.BUCKET_SLOTS)
        addrs = addr_t[bucks].reshape(n, self.SCAN_BUCKETS * self.BUCKET_SLOTS)
        best, ok = _first_verified((fps == fp[:, None]) & (addrs >= 0), addrs,
                                   lo, hi, klo, khi, limit=3)
        return vlo[best], vhi[best], ok

    def query(self, keys: np.ndarray, device=None) -> tuple:
        """A batch's CN-side hashes, taken on the host and moved in one
        copy: ``(bucket, fp, lo, hi)`` int32 tensors for
        :meth:`mn_get_batch`."""
        lo, hi = split_u64(np.asarray(keys, dtype=np.uint64))
        return _query(self.device if device is None else device,
                      _hash_range_np(lo, hi, 0x111CA, self.nb),
                      RaceKVS._fp(lo, hi), lo, hi)

    def get_batch(self, keys: np.ndarray, arrays=None):
        keys = np.asarray(keys, dtype=np.uint64)
        if arrays is None:
            arrays = self.mn_arrays()
        out = self.mn_get_batch(*self.query(keys, arrays[0].device), arrays)
        self.meter.add(int(keys.shape[0]), rts=1, req=16, resp=32, cn_hash=2,
                       mn_reads=self.SCAN_BUCKETS + 1,
                       mn_cmp=self.SCAN_BUCKETS * self.BUCKET_SLOTS + 1)
        return out

    def index_bytes(self) -> int:
        return self.t_fp.nbytes + self.t_addr.nbytes


class ClusterKVS(_HeapMixin):
    """Two-sided chained-associative baseline (RPC-Cluster hashing)."""

    BUCKET_SLOTS = 4
    MAX_CHAIN = 4
    _ROW_ARRAYS = (("fp", "t_fp"), ("addr", "t_addr"), ("nxt", "t_nxt"))
    _INDEX_DTYPES = {"fp": np.int32, "addr": np.int32, "nxt": np.int32}
    _SIZES = ("nb", "cap", "free_top")

    def __init__(self, keys: np.ndarray, values: np.ndarray, *,
                 load_factor: float = 0.8, rng_seed: int = 0, transport=None,
                 device=None):
        device = resolve_device(device)
        keys = np.asarray(keys, dtype=np.uint64)
        n = keys.shape[0]
        self._init_heap(keys, values)
        nbk = max(2, int(np.ceil(n / (self.BUCKET_SLOTS * load_factor))))
        cap = nbk + nbk // 2 + 8  # main + indirect bucket arena
        self.nb = nbk
        self.cap = cap
        lo, hi = split_u64(keys)
        self._build_chains(_hash_range_np(lo, hi, 0xC1C1, nbk),
                           self._fp14(lo, hi))
        self._init_device(device, transport)

    def _build_chains(self, home: np.ndarray, fps: np.ndarray) -> None:
        """The build's ``_insert_chain`` (legacy arena bound, no fp-shadow
        check) for every key in order, on Python lists: with no deletes a
        bucket's first free lane is its fill count."""
        n, cap, max_hops = home.shape[0], self.cap, self.MAX_CHAIN
        fill = [0] * cap
        nxt = [-1] * cap
        free_top = self.nb
        grp = np.empty(n, dtype=np.int64)
        slot = np.empty(n, dtype=np.int64)
        for c0, (h_l,) in _chunks(n, home):
            gs, ss = [], []
            for g in h_l:
                hops = 0
                while fill[g] >= 4:
                    if nxt[g] < 0:
                        if free_top >= cap or hops >= max_hops:
                            raise RuntimeError("cluster chain arena full")
                        nxt[g] = free_top
                        free_top += 1
                    g = nxt[g]
                    hops += 1
                    if hops > max_hops:
                        raise RuntimeError("cluster chain bound exceeded")
                gs.append(g)
                ss.append(fill[g])
                fill[g] += 1
            grp[c0:c0 + len(gs)] = gs
            slot[c0:c0 + len(ss)] = ss
        self.fp = np.zeros((cap, self.BUCKET_SLOTS), dtype=np.int32)  # 14-bit
        self.addr = np.full((cap, self.BUCKET_SLOTS), -1, dtype=np.int32)
        self.fp[grp, slot] = fps
        self.addr[grp, slot] = np.arange(n, dtype=np.int32)
        self.nxt = np.asarray(nxt, dtype=np.int32)  # chain pointer
        self.free_top = free_top

    @staticmethod
    def _fp14(lo, hi) -> np.ndarray:
        return (hash64_32_np(lo, hi, _FP14_SEED) & np.uint32(0x3FFF)) \
            .astype(np.uint16)

    def _insert_chain(self, g: int, fp: int, addr: int,
                      max_hops: int | None = None) -> None:
        """Place into the chain, extending it when needed.  ``max_hops``
        bounds how deep the walk may go (in hops past the home bucket);
        runtime Inserts pass ``MAX_CHAIN - 1`` so every chain stays within
        the ``MAX_CHAIN`` buckets the batched MN scan walks."""
        if max_hops is None:
            max_hops = self.MAX_CHAIN
        bounded = max_hops < self.MAX_CHAIN  # runtime (scan-visible) mode
        hops = 0
        while True:
            row = self.addr[g]
            free = np.nonzero(row < 0)[0]
            if free.size:
                s = int(free[0])
                # fp-shadow bound (runtime only): the batched scan verifies
                # one candidate per bucket — the first fp match — so a
                # same-fp lane at a lower index would shadow this key
                if bounded and bool(((self.fp[g, :s] == fp)
                                     & (self.addr[g, :s] >= 0)).any()):
                    raise RuntimeError("cluster fp-shadow bound: colliding "
                                       "fingerprint earlier in the bucket")
                self.fp[g, s] = fp
                self.addr[g, s] = addr
                self._rows.add(g)
                return
            if self.nxt[g] < 0:
                if self.free_top >= self.cap or hops >= max_hops:
                    raise RuntimeError("cluster chain arena full")
                self.nxt[g] = self.free_top
                self._rows.add(g)
                self.free_top += 1
            g = int(self.nxt[g])
            hops += 1
            if hops > max_hops:
                raise RuntimeError("cluster chain bound exceeded")

    def get(self, key: int):
        lo, hi, g, fp = self._home(*_split(key))
        self.meter.add(rts=1, req=16, resp=32, cn_hash=2, mn_hash=0)
        while g >= 0:  # MN walks the chain
            self.meter.add(0, mn_reads=1, mn_cmp=self.BUCKET_SLOTS,
                           attach=True)
            for s in range(self.BUCKET_SLOTS):
                if self.addr[g, s] >= 0 and int(self.fp[g, s]) == fp:
                    self.meter.add(0, mn_reads=1, mn_cmp=1, attach=True)
                    val = self._verify_and_read(int(self.addr[g, s]), lo, hi)
                    if val is not None:
                        return val
            g = int(self.nxt[g])
        return None

    # ------------------------------------------------------ mutations
    # Two-sided RPC mutations; the MN walks the bucket chain as ``get`` does.
    def _chain_find(self, lo: int, hi: int, fp: int, g: int):
        """(bucket, slot) of the key plus the number of chain hops read."""
        hops = 0
        while g >= 0:
            hops += 1
            for s in range(self.BUCKET_SLOTS):
                a = int(self.addr[g, s])
                if a >= 0 and int(self.fp[g, s]) == fp \
                        and int(self.h_klo[a]) == lo \
                        and int(self.h_khi[a]) == hi:
                    return (g, s), hops
            g = int(self.nxt[g])
        return None, hops

    def _home(self, lo: int, hi: int):
        return (lo, hi, hash_range_int(lo, hi, 0xC1C1, self.nb),
                hash64_32_int(lo, hi, _FP14_SEED) & 0x3FFF)

    def _home_batch(self, keys: np.ndarray):
        """Vectorised home bucket + 14-bit fingerprint for a key batch."""
        keys = np.asarray(keys, dtype=np.uint64)
        lo, hi = split_u64(keys)
        g = _hash_range_np(lo, hi, 0xC1C1, self.nb).astype(np.int64)
        return lo, hi, g, self._fp14(lo, hi)

    def _chain_find_batch(self, lo, hi, g, fp):
        """Vectorised chain walks for a mutation batch, on the host images:
        the reference's ``_chain_find_batch`` exactly.  Returns ``(walks,
        visited)``: per-lane ``(found, hops)`` tuples (``None`` for a chain
        deeper than the bound, rewalked scalar) plus an ``(n, steps)``
        array of the chain buckets each lane read (``-1`` padded)."""
        n = int(lo.shape[0])
        rows = np.arange(n)
        gg = np.asarray(g, dtype=np.int64).copy()
        live = np.ones(n, dtype=bool)
        found_b = np.full(n, -1, dtype=np.int64)
        found_s = np.zeros(n, dtype=np.int64)
        hops = np.zeros(n, dtype=np.int64)
        steps = self.MAX_CHAIN + 2  # home + MAX_CHAIN hops + slack
        visited = np.full((n, steps), -1, dtype=np.int64)
        for step in range(steps):
            if not live.any():
                break
            cur = np.where(live, gg, 0)
            visited[:, step] = np.where(live, cur, -1)
            hops += live
            a = self.addr[cur]                               # (n, S)
            cand = (a >= 0) & (self.fp[cur] == np.asarray(fp)[:, None]) \
                & live[:, None]
            ac = np.clip(a, 0, None)
            ver = cand & (self.h_klo[ac] == lo[:, None]) \
                & (self.h_khi[ac] == hi[:, None])
            first = np.argmax(ver, axis=1)
            hit = ver[rows, first]
            found_b = np.where(hit, cur, found_b)
            found_s = np.where(hit, first, found_s)
            live = live & ~hit
            gg = np.where(live, self.nxt[cur], -1)
            live = live & (gg >= 0)
        walks = []
        for i in range(n):
            if live[i]:  # chain deeper than the bound: rewalk scalar
                walks.append(None)
                continue
            fnd = ((int(found_b[i]), int(found_s[i]))
                   if found_b[i] >= 0 else None)
            walks.append((fnd, int(hops[i])))
        return walks, visited

    @_synced
    def insert_batch(self, keys, values) -> list[str]:
        lo, hi, g, fp = self._home_batch(keys)
        values = np.asarray(values, dtype=np.uint64)
        walks, visited = self._chain_find_batch(lo, hi, g, fp)
        out = []
        mutated: set[int] = set()  # buckets structurally changed so far
        dirty_all = False          # an untracked (scalar-path) mutation
        for i in range(len(values)):
            w = walks[i]
            vis = [int(b) for b in visited[i] if b >= 0]
            if dirty_all or (mutated and not mutated.isdisjoint(vis)):
                w = None  # stale precompute: rewalk scalar
            ret = self._insert_at(int(lo[i]), int(hi[i]), int(g[i]),
                                  int(fp[i]), int(values[i]), walk=w)
            if ret == "slot":
                # the placed slot (and any chain extension's new tail
                # pointer) lies along this lane's read chain
                if w is not None:
                    mutated.update(vis)
                else:
                    dirty_all = True
            out.append(ret)
        return out

    @_synced
    def update_batch(self, keys, values) -> np.ndarray:
        lo, hi, g, fp = self._home_batch(keys)
        values = np.asarray(values, dtype=np.uint64)
        # heap-value-only writes: precomputed walks cannot go stale
        walks, _ = self._chain_find_batch(lo, hi, g, fp)
        return np.asarray([self._update_at(int(lo[i]), int(hi[i]), int(g[i]),
                                           int(fp[i]), int(values[i]),
                                           walk=walks[i])
                           for i in range(len(values))], dtype=bool)

    @_synced
    def delete_batch(self, keys) -> np.ndarray:
        lo, hi, g, fp = self._home_batch(keys)
        walks, visited = self._chain_find_batch(lo, hi, g, fp)
        out = np.zeros(lo.shape[0], dtype=bool)
        mutated: set[int] = set()
        dirty_all = False
        for i in range(lo.shape[0]):
            w = walks[i]
            vis = [int(b) for b in visited[i] if b >= 0]
            if dirty_all or (mutated and not mutated.isdisjoint(vis)):
                w = None
            ok = self._delete_at(int(lo[i]), int(hi[i]), int(g[i]),
                                 int(fp[i]), walk=w)
            if ok:  # freed a lane: structural change
                if w is not None:
                    mutated.add(w[0][0])
                else:
                    dirty_all = True
            out[i] = ok
        return out

    @_synced
    def insert(self, key: int, value: int) -> str:
        return self._insert_at(*self._home(*_split(key)), int(value))

    def _insert_at(self, lo, hi, g, fp, value, walk=None) -> str:
        found, hops = \
            self._chain_find(lo, hi, fp, g) if walk is None else walk
        self.meter.add(rts=1, req=16 + 32, resp=8, cn_hash=2, mn_reads=hops,
                       mn_cmp=hops * self.BUCKET_SLOTS, mn_writes=1)
        if found is not None:
            self._heap_set_value(int(self.addr[found]), value)
            return "update"
        addr = self._heap_append(lo, hi, value & _M32, (value >> 32) & _M32)
        try:
            # MAX_CHAIN - 1 hops past home == the MAX_CHAIN buckets the
            # batched scan walks: runtime inserts stay scan-visible
            self._insert_chain(g, fp, addr, max_hops=self.MAX_CHAIN - 1)
        except RuntimeError:
            self.heap_top -= 1  # roll back the tail append; unreferenced
            raise
        self.n_keys += 1
        return "slot"

    @_synced
    def update(self, key: int, value: int) -> bool:
        return self._update_at(*self._home(*_split(key)), int(value))

    def _update_at(self, lo, hi, g, fp, value, walk=None) -> bool:
        found, hops = \
            self._chain_find(lo, hi, fp, g) if walk is None else walk
        self.meter.add(rts=1, req=16 + 32, resp=8, cn_hash=2, mn_reads=hops,
                       mn_cmp=hops * self.BUCKET_SLOTS,
                       mn_writes=1 if found else 0)
        if found is None:
            return False
        self._heap_set_value(int(self.addr[found]), value)
        return True

    @_synced
    def delete(self, key: int) -> bool:
        return self._delete_at(*self._home(*_split(key)))

    def _delete_at(self, lo, hi, g, fp, walk=None) -> bool:
        found, hops = \
            self._chain_find(lo, hi, fp, g) if walk is None else walk
        self.meter.add(rts=1, req=16, resp=8, cn_hash=2, mn_reads=hops,
                       mn_cmp=hops * self.BUCKET_SLOTS,
                       mn_writes=1 if found else 0)
        if found is None:
            return False
        self.fp[found] = 0
        self.addr[found] = -1
        self._rows.add(found[0])
        self.n_keys -= 1
        return True

    def mn_arrays(self) -> tuple:
        """The device arrays ``mn_get_batch``'s ``arrays`` take."""
        return (self.t_fp, self.t_addr, self.t_nxt, self.t_klo, self.t_khi,
                self.t_vlo, self.t_vhi)

    def mn_get_batch(self, bucket, fp, lo, hi, arrays):
        """MN work: the chain of up to MAX_CHAIN buckets from ``bucket``
        (pointers followed first), then in each bucket the first
        fingerprint hit verified; the first bucket that verifies wins."""
        fp_t, addr_t, nxt, klo, khi, vlo, vhi = arrays
        g = bucket.long()
        chain = [g]
        for _ in range(self.MAX_CHAIN - 1):
            g = torch.where(g >= 0, nxt[g.clamp(min=0)].long(), -1)
            chain.append(g)
        chain = torch.stack(chain, 1)                           # (B, C)
        gg = chain.clamp(min=0)
        addrs = addr_t[gg]                                      # (B, C, S)
        hit = (fp_t[gg] == fp[:, None, None]) & (addrs >= 0) \
            & (chain >= 0)[:, :, None]
        first = torch.argmax(hit.to(torch.uint8), 2, keepdim=True)
        a = addrs.gather(2, first).squeeze(2)                   # (B, C)
        best, found = _first_verified(hit.any(2), a, lo, hi, klo, khi)
        return vlo[best], vhi[best], found

    def query(self, keys: np.ndarray, device=None) -> tuple:
        """A batch's CN-side hashes, taken on the host and moved in one
        copy: ``(bucket, fp, lo, hi)`` int32 tensors for
        :meth:`mn_get_batch`."""
        lo, hi = split_u64(np.asarray(keys, dtype=np.uint64))
        return _query(self.device if device is None else device,
                      _hash_range_np(lo, hi, 0xC1C1, self.nb),
                      self._fp14(lo, hi), lo, hi)

    def get_batch(self, keys: np.ndarray, arrays=None):
        keys = np.asarray(keys, dtype=np.uint64)
        if arrays is None:
            arrays = self.mn_arrays()
        out = self.mn_get_batch(*self.query(keys, arrays[0].device), arrays)
        # Average chain length ~1.2 at lf 0.8; account the worst-case walk
        # the vectorised MN scan actually performs.
        self.meter.add(int(keys.shape[0]), rts=1, req=16, resp=32, cn_hash=2,
                       mn_reads=2, mn_cmp=self.BUCKET_SLOTS + 1)
        return out

    def index_bytes(self) -> int:
        return self.t_fp.nbytes + self.t_addr.nbytes + self.t_nxt.nbytes


class DummyKVS(_HeapMixin):
    """RPC-Dummy: the MN answers every request with one fixed memory read."""

    _SIZES = ("n",)

    def __init__(self, keys: np.ndarray, values: np.ndarray, *,
                 transport=None, device=None, **_):
        device = resolve_device(device)
        keys = np.asarray(keys, dtype=np.uint64)
        self._init_heap(keys, values)
        self.n = keys.shape[0]
        self._init_device(device, transport)

    def get(self, key: int):
        self.meter.add(rts=1, req=16, resp=32, mn_reads=1)
        return (int(self.h_vhi[0]) << 32) | int(self.h_vlo[0])

    # Mutations model one fixed memory write each — the RPC-Dummy upper
    # bound has no index to maintain and never reads stored data back
    # (``verifies_keys=False`` on its adapter), so only the meter moves.
    def insert(self, key: int, value: int) -> str:
        self.meter.add(rts=1, req=16 + 32, resp=8, mn_writes=1)
        return "slot"

    def update(self, key: int, value: int) -> bool:
        self.meter.add(rts=1, req=16 + 32, resp=8, mn_writes=1)
        return True

    def delete(self, key: int) -> bool:
        self.meter.add(rts=1, req=16, resp=8, mn_writes=1)
        return True

    # Batched mutations are pure meter movements (identical totals to the
    # scalar loop): the upper-bound model maintains no index state.
    def insert_batch(self, keys, values) -> list[str]:
        n = int(np.asarray(keys).shape[0])
        self.meter.add(n, rts=1, req=16 + 32, resp=8, mn_writes=1)
        return ["slot"] * n

    def update_batch(self, keys, values) -> np.ndarray:
        n = int(np.asarray(keys).shape[0])
        self.meter.add(n, rts=1, req=16 + 32, resp=8, mn_writes=1)
        return np.ones(n, dtype=bool)

    def delete_batch(self, keys) -> np.ndarray:
        n = int(np.asarray(keys).shape[0])
        self.meter.add(n, rts=1, req=16, resp=8, mn_writes=1)
        return np.ones(n, dtype=bool)

    def mn_arrays(self) -> tuple:
        return (self.t_vlo, self.t_vhi)

    def mn_get_batch(self, idx, arrays):
        vlo, vhi = arrays
        a = idx.long() % self.n
        return vlo[a], vhi[a], torch.ones(idx.shape[0], dtype=torch.bool,
                                          device=idx.device)

    def query(self, keys: np.ndarray, device=None) -> tuple:
        """``(idx,)``: each key's heap index, taken on the host in uint64,
        then int32 — never as a signed op on the card."""
        idx = (np.asarray(keys, dtype=np.uint64) % np.uint64(self.n))
        return (torch.from_numpy(idx.astype(np.int32))
                .to(self.device if device is None else device),)

    def get_batch(self, keys: np.ndarray, arrays=None):
        keys = np.asarray(keys, dtype=np.uint64)
        if arrays is None:
            arrays = self.mn_arrays()
        out = self.mn_get_batch(*self.query(keys, arrays[0].device), arrays)
        self.meter.add(int(keys.shape[0]), rts=1, req=16, resp=32,
                       mn_reads=1)
        return out

    def index_bytes(self) -> int:
        return 0
