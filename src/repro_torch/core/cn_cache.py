"""Compute-node adaptive hot-key cache (the CN cache), with its state on the device.

The port of ``repro.core.cn_cache``.  A small CN-side cache of hot KV pairs
answers the head of a skewed (zipfian) Get stream without a round trip; its
CLOCK, TinyLFU and negative-cache state, its statistics and its admission
decisions are the reference's, step for step.

Structure (device tensors; key and value lanes are int32 tensors holding
uint32 bit patterns, like every other lane of the port):

* **value table** — W-way set-associative over ``nsets`` (a power of two)
  sets: ``k_lo``/``k_hi``/``v_lo``/``v_hi`` (nsets, W) int32, ``valid`` and
  ``ref`` (nsets, W) uint8 and a CLOCK hand a set, ``hand`` (nsets,) uint8.
* **admission sketch** — ``sketch`` (2, sketch_w) uint8, a 2-row count-min
  sketch of saturating counters; a missed key is admitted once its estimate
  reaches ``admit_threshold`` and, into a full set, only if it beats the
  CLOCK victim's estimate.  The sketch is halved once ``aging_window``
  observations have been counted.
* **negative cache** — ``nk_lo``/``nk_hi`` (nneg,) int32 and ``nvalid``
  uint8, direct-mapped: keys known absent.

A batch's keys arrive from the host, and its index math runs there
(:func:`repro_torch.core.hashing.hash64_32_np`): each key's set, negative
slot and two sketch counters, for a whole window in a few numpy calls,
where the same hashes on the device cost a few dozen launches.  The
batched probe (:func:`cache_probe`, :func:`neg_probe`) then gathers and
compares on the device.  The bookkeeping of :meth:`CNKeyCache.observe_batch`
and of the coherence notes runs on the host over what one device->host
copy brings (the rows of the sets the batch touches, the sketch counters
of its keys), in the reference's order — the admissions one key at a time,
in ascending uint64 key order — and goes back in one host->device copy and
a scatter an array.

Coherence rules (the reference's):

* ``Update``  -> refresh the cached value in place, clear any negative entry;
* ``Delete``  -> drop the positive entry;
* ``Insert``  -> clear the negative entry, refresh the value if cached;
* **resize**  -> the directory split drops every entry routed to the table
  being rebuilt (``OutbackStore`` calls :meth:`CNKeyCache.invalidate_where`,
  torch ops over the device arrays).

The ``note_*_batch`` calls apply a batch of such notes at once, with the
result of noting the lanes one by one in order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hashing import hash64_32, hash64_32_np, join_u64, split_u64
from repro_torch.core.outback import resolve_device

_SET_SEED = 0xCACE5E7
_SKETCH_SEED_A = 0x5EE71
_SKETCH_SEED_B = 0x5EE72
_NEG_SEED = 0x0FF5E7
# the seeds of a key's four indices, in the order CNKeyCache._index gives them
_INDEX_SEEDS = np.array([[_SET_SEED], [_NEG_SEED], [_SKETCH_SEED_A],
                         [_SKETCH_SEED_B]], np.uint32)

ENTRY_BYTES = 18  # k_lo+k_hi+v_lo+v_hi (16) + valid/ref bits + set-hand share
NEG_ENTRY_BYTES = 9  # k_lo+k_hi + valid bit

_M32 = 0xFFFFFFFF
# the value table's arrays, in the order of a host image's rows
_ROW_ARRAYS = ("k_lo", "k_hi", "v_lo", "v_hi", "valid", "ref")
_BYTE_ARRAYS = ("valid", "ref", "hand", "sketch", "nvalid")


@dataclasses.dataclass
class CNCacheStats:
    hits: int = 0
    neg_hits: int = 0
    misses: int = 0
    admitted: int = 0
    evicted: int = 0
    invalidated: int = 0
    neg_admitted: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    @property
    def lookups(self) -> int:
        return self.hits + self.neg_hits + self.misses

    @property
    def hit_rate(self) -> float:
        return (self.hits + self.neg_hits) / max(1, self.lookups)


def _pow2_at_most(x: int) -> int:
    return 1 << max(0, int(x).bit_length() - 1)


def _host_u32(x) -> np.ndarray:
    """uint32 lanes (host numpy, or an int32 bit-pattern tensor) as host
    uint32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32).cpu().numpy().view(np.uint32).reshape(-1)
    return np.asarray(x, np.uint32).reshape(-1)


def _host_bool(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(bool).reshape(-1)
    return np.asarray(x, bool).reshape(-1)


def _last_of_each(x: np.ndarray) -> np.ndarray:
    """Index of the last occurrence of each distinct value of ``x``."""
    _, idx = np.unique(x[::-1], return_index=True)
    return x.size - 1 - idx


class _Set:
    """Host image of one set during admissions: each way's lanes, valid and
    ref bits, the sketch estimate of the key it holds, and the CLOCK hand."""

    __slots__ = ("k_lo", "k_hi", "v_lo", "v_hi", "valid", "ref", "est",
                 "hand")

    def __init__(self, k_lo, k_hi, v_lo, v_hi, valid, ref, est, hand):
        self.k_lo, self.k_hi, self.v_lo, self.v_hi = k_lo, k_hi, v_lo, v_hi
        self.valid, self.ref, self.est, self.hand = valid, ref, est, hand

    def find(self, lo: int, hi: int):
        for w, (a, b, ok) in enumerate(zip(self.k_lo, self.k_hi,
                                           self.valid)):
            if ok and a == lo and b == hi:
                return w
        return None


class CNKeyCache:
    """Fixed-budget CN-side hot-KV cache with frequency-based admission.

    ``device=None`` means CUDA, and raises when there is no card; the tests
    pass ``device="cpu"``."""

    WAYS = 4

    def __init__(self, budget_bytes: int, *, ways: int = WAYS,
                 admit_threshold: int = 2, neg_frac: float = 0.10,
                 sketch_frac: float = 0.20, device=None):
        if budget_bytes < 1024:
            raise ValueError("CN cache budget below 1 KiB is meaningless")
        self.device = resolve_device(device)
        self.budget_bytes = int(budget_bytes)
        self.ways = ways
        self.admit_threshold = int(admit_threshold)

        value_budget = int(budget_bytes * (1.0 - neg_frac - sketch_frac))
        self.nsets = max(2, _pow2_at_most(value_budget // (ways * ENTRY_BYTES)))
        self.nneg = max(2, _pow2_at_most(int(budget_bytes * neg_frac)
                                         // NEG_ENTRY_BYTES))
        self.sketch_w = max(4, _pow2_at_most(int(budget_bytes * sketch_frac)
                                             // 2))
        S, W = self.nsets, self.ways
        self._install(dict(
            k_lo=np.zeros((S, W), np.uint32), k_hi=np.zeros((S, W), np.uint32),
            v_lo=np.zeros((S, W), np.uint32), v_hi=np.zeros((S, W), np.uint32),
            valid=np.zeros((S, W), np.uint8), ref=np.zeros((S, W), np.uint8),
            hand=np.zeros(S, np.uint8),
            sketch=np.zeros((2, self.sketch_w), np.uint8), sketch_obs=0,
            nk_lo=np.zeros(self.nneg, np.uint32),
            nk_hi=np.zeros(self.nneg, np.uint32),
            nvalid=np.zeros(self.nneg, np.uint8), stats={}))

    # ------------------------------------------------------- carrying state
    _ARRAYS = _ROW_ARRAYS + ("hand", "sketch", "nk_lo", "nk_hi", "nvalid")

    @classmethod
    def from_reference_state(cls, state: dict, *, device=None,
                             admit_threshold: int = 2) -> "CNKeyCache":
        """A cache that continues exactly as a ``repro`` cache would, from
        that cache's state: ``state`` holds its numpy arrays (``k_lo``,
        ``k_hi``, ``v_lo``, ``v_hi``, ``valid``, ``ref``, ``hand``,
        ``sketch``, ``nk_lo``, ``nk_hi``, ``nvalid``), ``sketch_obs`` (its
        ``_sketch_obs``), ``budget_bytes`` and ``stats`` (a dict of
        :class:`CNCacheStats` fields).  The sizes follow from the arrays'
        shapes."""
        c = cls.__new__(cls)
        c.device = resolve_device(device)
        c.budget_bytes = int(state["budget_bytes"])
        c.admit_threshold = int(admit_threshold)
        c.nsets, c.ways = (int(x) for x in np.shape(state["k_lo"]))
        c.nneg = int(np.shape(state["nk_lo"])[0])
        c.sketch_w = int(np.shape(state["sketch"])[1])
        c._install(state)
        return c

    def _install(self, state: dict) -> None:
        for name in self._ARRAYS:
            a = np.asarray(state[name])
            if name in _BYTE_ARRAYS:
                t = torch.from_numpy(np.array(a, dtype=np.uint8))
            else:
                t = torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))
            setattr(self, name, t.to(self.device))
        self._sketch_obs = int(state["sketch_obs"])
        self.aging_window = 8 * self.nsets * self.ways
        self.stats = CNCacheStats(**dict(state["stats"]))
        self._masks = np.array([[self.nsets - 1], [self.nneg - 1],
                                [self.sketch_w - 1], [self.sketch_w - 1]],
                               np.int64)

    def state(self) -> dict:
        """Host (numpy) image of the whole cache, in the reference's dtypes:
        what :meth:`from_reference_state` takes."""
        out = {}
        for name in self._ARRAYS:
            a = getattr(self, name).cpu().numpy()
            out[name] = a.view(np.uint32).copy() if a.dtype == np.int32 \
                else a.copy()
        out["sketch_obs"] = self._sketch_obs
        out["budget_bytes"] = self.budget_bytes
        out["stats"] = dataclasses.asdict(self.stats)
        return out

    # ------------------------------------------------------------ accounting
    def memory_bytes(self) -> int:
        """Actual bytes of CN memory this cache occupies (<= budget), as the
        reference counts them."""
        S, W = self.nsets, self.ways
        return (4 * 4 * S * W + (S * W * 2) // 8
                + S  # hands
                + 2 * self.sketch_w
                + self.nneg * NEG_ENTRY_BYTES)

    @property
    def capacity(self) -> int:
        return self.nsets * self.ways

    # ------------------------------------------------------ host <-> device
    def _index(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Each key's set, negative slot and two sketch counters (row 0 and
        row 1), int64 numpy (4, n), hashed on the host."""
        h = hash64_32_np(lo[None, :], hi[None, :], _INDEX_SEEDS)
        return h.astype(np.int64) & self._masks

    def _pull(self, sets=None, slots=None, counters=None) -> dict:
        """One host->device copy of the indices and one device->host copy
        of what they select: the value table's rows at ``sets`` (``k_lo``
        ... ``ref`` (m, W) and ``hand`` (m,)), the negative cache at
        ``slots`` (``nk_lo``, ``nk_hi``, ``nvalid``) and the sketch counters
        at flat positions ``counters`` (row 1 starts at ``sketch_w``), as
        host numpy uint32."""
        parts = [np.zeros(0, np.int64) if x is None else np.asarray(x, np.int64)
                 for x in (sets, slots, counters)]
        sizes = [p.size for p in parts]
        si, ni, ci = torch.from_numpy(np.concatenate(parts)).to(
            self.device).split(sizes)
        picked = []
        if sizes[0]:
            picked += [(n, getattr(self, n)[si]) for n in _ROW_ARRAYS]
            picked.append(("hand", self.hand[si]))
        if sizes[1]:
            picked += [(n, getattr(self, n)[ni])
                       for n in ("nk_lo", "nk_hi", "nvalid")]
        if sizes[2]:
            picked.append(("counters", self.sketch.view(-1)[ci]))
        if not picked:
            return {}
        flat = torch.cat([t.reshape(-1).to(torch.int32) for _, t in picked])
        flat = flat.cpu().numpy().view(np.uint32)
        out, pos = {}, 0
        for name, t in picked:
            out[name] = flat[pos:pos + t.numel()].reshape(t.shape)
            pos += t.numel()
        return out

    def _push_rows(self, sets: np.ndarray, rows: dict) -> None:
        """Write host images of the value table's rows at ``sets`` (the
        arrays of :meth:`_pull`) back to the device: one copy, a scatter an
        array."""
        if not sets.size:
            return
        W = self.ways
        blk = np.concatenate(
            [sets.astype(np.uint32)[:, None]]
            + [np.asarray(rows[n], np.uint32).reshape(-1, W)
               for n in _ROW_ARRAYS]
            + [np.asarray(rows["hand"], np.uint32)[:, None]], axis=1)
        t = torch.from_numpy(blk.view(np.int32)).to(self.device)
        idx = t[:, 0].long()
        for j, name in enumerate(_ROW_ARRAYS):
            dst = getattr(self, name)
            dst[idx] = t[:, 1 + j * W:1 + (j + 1) * W].to(dst.dtype)
        self.hand[idx] = t[:, -1].to(torch.uint8)

    # --------------------------------------------------------------- sketch
    def _sketch_bump(self, a: np.ndarray, b: np.ndarray,
                     count: np.ndarray) -> None:
        """Saturating add of ``count`` (one a key) at each key's counters
        ``a`` (row 0) and ``b`` (row 1), as the reference's ``np.add.at``
        into uint32 then the cap at 255: summed per counter on the host,
        one gather, add and scatter on the device.  The sketch is halved
        once per call, after the bump, when the observations reach the
        aging window."""
        count = np.asarray(count, np.int64)
        flat, inv = np.unique(np.concatenate([a, self.sketch_w + b]),
                              return_inverse=True)
        add = np.zeros(flat.size, np.int64)
        np.add.at(add, inv, np.concatenate([count, count]))
        t = torch.from_numpy(np.stack([flat, add])).to(self.device)
        sk = self.sketch.view(-1)
        sk[t[0]] = (sk[t[0]].long() + t[1]).clamp_(max=255).to(torch.uint8)
        self._sketch_obs += int(count.sum())
        if self._sketch_obs >= self.aging_window:
            self.sketch >>= 1  # periodic halving: the "adaptive" part
            self._sketch_obs = 0

    def _estimates(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """The sketch's estimate of each key (one device round trip)."""
        _, _, a, b = self._index(lo, hi)
        c = self._pull(counters=np.concatenate([a, self.sketch_w + b]))
        c = c["counters"].astype(np.int64)
        return np.minimum(c[:lo.size], c[lo.size:])

    # ------------------------------------------------------------ host probe
    def lookup(self, key: int):
        """One CN-side probe.  Returns ``('hit', value)``, ``('neg', None)``
        or ``('miss', None)`` — and counts the access toward admission."""
        lo, hi = split_u64(np.uint64([key]))
        s, n, a, b = self._index(lo, hi)
        self._sketch_bump(a, b, np.ones(1, np.int64))
        p = self._pull(sets=s, slots=n)
        lo, hi = int(lo[0]), int(hi[0])
        for w in range(self.ways):
            if (p["valid"][0, w] and p["k_lo"][0, w] == lo
                    and p["k_hi"][0, w] == hi):
                self.ref[int(s[0]), w] = 1
                self.stats.hits += 1
                return "hit", (int(p["v_hi"][0, w]) << 32) | int(p["v_lo"][0, w])
        if p["nvalid"][0] and p["nk_lo"][0] == lo and p["nk_hi"][0] == hi:
            self.stats.neg_hits += 1
            return "neg", None
        self.stats.misses += 1
        return "miss", None

    # -------------------------------------------------------------- fills
    def fill(self, key: int, value: int | None) -> None:
        """Offer a miss result for admission (value ``None`` == absent)."""
        lo, hi = split_u64(np.uint64([key]))
        s, n, a, b = self._index(lo, hi)
        p = self._pull(sets=s, counters=np.concatenate([a, self.sketch_w + b]))
        est = int(p["counters"].min())
        if est < self.admit_threshold:
            return
        if value is None:
            self._neg_admit(lo, hi, n)
            return
        value = int(value)
        self._admit(p, [(0, int(lo[0]), int(hi[0]), value & _M32,
                         (value >> 32) & _M32, est)])
        self._push_rows(s, p)

    def _neg_admit(self, lo: np.ndarray, hi: np.ndarray,
                   slots: np.ndarray) -> None:
        """Negative admissions of the keys ``(lo, hi)`` in order: a later
        key takes a slot an earlier one took."""
        if not slots.size:
            return
        last = _last_of_each(slots)
        blk = np.stack([slots[last].astype(np.uint32), lo[last], hi[last]])
        t = torch.from_numpy(blk.view(np.int32)).to(self.device)
        idx = t[0].long()
        self.nk_lo[idx], self.nk_hi[idx] = t[1], t[2]
        self.nvalid[idx] = 1
        self.stats.neg_admitted += int(slots.size)

    def _admit(self, rows: dict, cands: list) -> np.ndarray:
        """Positive admissions, one key at a time in the order of ``cands``
        — ``(row, lo, hi, v_lo, v_hi, est)``, ``row`` indexing the host
        image ``rows`` of :meth:`_pull` — over list images of the sets they
        touch, copied back into ``rows``; returns the rows touched, for the
        caller to write back.  The estimates of the keys the full sets hold
        are read (one round trip) only if a set may fill."""
        W = self.ways
        per_set = np.bincount([c[0] for c in cands],
                              minlength=len(rows["hand"]))
        touched = np.nonzero(per_set)[0]
        est = np.zeros((touched.size, W), np.int64)
        may_fill = per_set[touched] > (rows["valid"][touched] == 0).sum(1)
        if may_fill.any():  # victims may be needed: their estimates
            r = touched[may_fill]
            est[may_fill] = self._estimates(
                rows["k_lo"][r].reshape(-1),
                rows["k_hi"][r].reshape(-1)).reshape(-1, W)
        sub = [rows[n][touched].tolist() for n in _ROW_ARRAYS]
        sub += [est.tolist(), rows["hand"][touched].tolist()]
        img = {r: _Set(*(x[i] for x in sub))
               for i, r in enumerate(touched.tolist())}
        for r, lo, hi, vlo, vhi, e in cands:
            self._admit_one(img[r], lo, hi, vlo, vhi, e)
        sets = list(img.values())
        for n in _ROW_ARRAYS + ("hand",):
            rows[n][touched] = np.array([getattr(x, n) for x in sets],
                                        np.uint32)
        return touched

    def _admit_one(self, row: _Set, lo: int, hi: int, vlo: int, vhi: int,
                   est: int) -> None:
        w = row.find(lo, hi)
        if w is None:
            free = [u for u in range(self.ways) if not row.valid[u]]
            if free:
                w = free[0]
            else:
                w = self._clock_victim(row)
                if est < row.est[w]:  # TinyLFU gate: don't evict a hotter key
                    return
                self.stats.evicted += 1
            self.stats.admitted += 1
        row.k_lo[w], row.k_hi[w] = lo, hi
        row.v_lo[w], row.v_hi[w] = vlo, vhi
        row.valid[w] = 1
        row.ref[w] = 1
        row.est[w] = est

    def _clock_victim(self, row: _Set) -> int:
        start = row.hand
        for i in range(2 * self.ways):
            w = (start + i) % self.ways
            if row.ref[w]:
                row.ref[w] = 0  # second chance
            else:
                row.hand = (w + 1) % self.ways
                return w
        w = start % self.ways
        row.hand = (w + 1) % self.ways
        return w

    # ---------------------------------------------------------- coherence
    def _resident(self, keys: np.ndarray):
        """Where the value table holds the last lane of each distinct key of
        ``keys`` (flat positions, and those lanes), and which negative slots
        hold one of the keys, from one device round trip."""
        lo, hi = split_u64(keys)
        s, n, _, _ = self._index(lo, hi)
        p = self._pull(sets=s, slots=n)
        hitw = ((p["k_lo"] == lo[:, None]) & (p["k_hi"] == hi[:, None])
                & (p["valid"] != 0))
        on = np.zeros(keys.size, bool)
        on[_last_of_each(keys)] = True
        on &= hitw.any(axis=1)
        pos = s[on] * self.ways + hitw.argmax(axis=1)[on]
        stale = (p["nk_lo"] == lo) & (p["nk_hi"] == hi) & (p["nvalid"] != 0)
        return pos, on, np.unique(n[stale])

    def note_update_batch(self, keys, values) -> None:
        """Successful Updates of ``keys`` in lane order: refresh cached
        values in place (the last lane of a key wins), clear stale
        absence."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        if not keys.size:
            return
        pos, on, stale = self._resident(keys)
        v_lo, v_hi = split_u64(np.asarray(values, np.uint64).reshape(-1))
        if pos.size:
            blk = np.stack([pos.astype(np.uint32), v_lo[on], v_hi[on]])
            t = torch.from_numpy(blk.view(np.int32)).to(self.device)
            idx = t[0].long()
            self.v_lo.view(-1)[idx], self.v_hi.view(-1)[idx] = t[1], t[2]
        if stale.size:
            self.nvalid[torch.from_numpy(stale).to(self.device)] = 0

    # An Insert that resolved to an in-place update refreshes the cached
    # value; either way the key now exists.
    note_insert_batch = note_update_batch

    def note_delete_batch(self, keys) -> None:
        """Successful Deletes of ``keys``: drop their positive entries."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        if not keys.size:
            return
        pos, _, _ = self._resident(keys)
        if pos.size:
            idx = torch.from_numpy(pos).to(self.device)
            self.valid.view(-1)[idx] = 0
            self.ref.view(-1)[idx] = 0
        self.stats.invalidated += int(pos.size)

    def note_update(self, key: int, value: int) -> None:
        """A successful Update: refresh in place, clear stale absence."""
        self.note_update_batch(np.uint64([key]), np.uint64([value]))

    def note_insert(self, key: int, value: int) -> None:
        """A successful Insert: the key now exists."""
        self.note_insert_batch(np.uint64([key]), np.uint64([value]))

    def note_delete(self, key: int) -> None:
        """A successful Delete: drop the positive entry."""
        self.note_delete_batch(np.uint64([key]))

    def invalidate_where(self, pred) -> int:
        """Drop every entry whose key satisfies ``pred(k_lo, k_hi) -> bool
        mask`` (torch ops over the cache's int32 lanes on its device).
        Used by the store's resize path."""
        mask = (self.valid != 0) & pred(self.k_lo, self.k_hi)
        nmask = (self.nvalid != 0) & pred(self.nk_lo, self.nk_hi)
        n, n_neg = torch.stack([mask.sum(), nmask.sum()]).tolist()
        self.valid[mask] = 0
        self.ref[mask] = 0
        self.nvalid[nmask] = 0
        self.stats.invalidated += n + n_neg
        return n

    def invalidate_all(self) -> None:
        n, n_neg = torch.stack([(self.valid != 0).sum(),
                                (self.nvalid != 0).sum()]).tolist()
        self.stats.invalidated += n + n_neg
        self.valid.zero_()
        self.ref.zero_()
        self.nvalid.zero_()

    # ------------------------------------------------------- batched paths
    def probe_batch(self, lo, hi):
        """Batched probe of host uint32 lanes: (hit, neg, v_lo, v_hi)
        tensors on the cache's device, gathered and compared there.  Does
        NOT update any cache state — pair with :meth:`observe_batch`."""
        lo, hi = _host_u32(lo), _host_u32(hi)
        s, n, _, _ = self._index(lo, hi)
        blk = np.stack([lo, hi, s.astype(np.uint32), n.astype(np.uint32)])
        t = torch.from_numpy(blk.view(np.int32)).to(self.device)
        hit, vlo, vhi = cache_probe(t[0], t[1], self.arrays(), self.nsets,
                                    sets=t[2].long())
        neg = neg_probe(t[0], t[1], self.neg_arrays(), self.nneg,
                        slots=t[3].long()) & ~hit
        return hit, neg, vlo, vhi

    def observe_batch(self, lo, hi, v_lo, v_hi, present, hit,
                      neg=None) -> None:
        """Account a batched Get: bump frequencies, refresh CLOCK refs for
        hits, run admission for the (present) misses and the negative cache
        for repeatedly-absent keys.  Takes host arrays (or tensors, which
        come to the host)."""
        lo, hi = _host_u32(lo), _host_u32(hi)
        v_lo, v_hi = _host_u32(v_lo), _host_u32(v_hi)
        present, hit = _host_bool(present), _host_bool(hit)
        neg = np.zeros_like(hit) if neg is None else _host_bool(neg)
        self.stats.hits += int(hit.sum())
        self.stats.neg_hits += int(neg.sum())

        _, first, counts = np.unique(join_u64(lo, hi), return_index=True,
                                     return_counts=True)
        ulo, uhi = lo[first], hi[first]
        s, n, a, b = self._index(ulo, uhi)
        self._sketch_bump(a, b, counts)

        missed = ~hit & ~neg
        self.stats.misses += int(missed.sum())
        uhit = hit[first]
        if not (uhit.any() or missed.any()):
            return
        # one round trip: the rows of the keys' sets and their counters
        sets, row = np.unique(s, return_inverse=True)
        u = ulo.size
        rows = self._pull(sets=sets, counters=np.concatenate(
            [a, self.sketch_w + b]) if missed.any() else None)
        # CLOCK ref refresh for hit keys
        r = row[uhit]
        match = ((rows["k_lo"][r] == ulo[uhit, None])
                 & (rows["k_hi"][r] == uhi[uhit, None])
                 & (rows["valid"][r] != 0))
        on = match.any(axis=1)
        rows["ref"][r[on], match.argmax(axis=1)[on]] = 1
        dirty = r[on]
        if missed.any():
            c = rows.pop("counters").astype(np.int64)
            est = np.minimum(c[:u], c[u:])
            upresent = present[first]
            # the caller's probe already told us who is cached — no re-probe
            cand = ~uhit & (est >= self.admit_threshold)
            # positive admissions: one key at a time, in ascending key order
            pos = np.nonzero(cand & upresent)[0]
            if pos.size:
                dirty = np.concatenate([dirty, self._admit(rows, [
                    (row[i], int(ulo[i]), int(uhi[i]), int(v_lo[first[i]]),
                     int(v_hi[first[i]]), int(est[i])) for i in pos])])
            # negative admissions for repeatedly-missing keys
            negc = np.nonzero(cand & ~upresent)[0]
            self._neg_admit(ulo[negc], uhi[negc], n[negc])
        dirty = np.unique(dirty)
        self._push_rows(sets[dirty], {k: v[dirty] for k, v in rows.items()})

    # ------------------------------------------------------- device export
    def arrays(self):
        return self.k_lo, self.k_hi, self.v_lo, self.v_hi, self.valid

    def neg_arrays(self):
        return self.nk_lo, self.nk_hi, self.nvalid


# ---------------------------------------------------------------------------
# pure probe functions (torch ops on the device of their inputs)


def cache_probe(lo, hi, cache_arrays, nsets, *, sets=None):
    """Set-associative probe over a cache's arrays.

    ``lo``/``hi`` are int32 lanes; returns ``(hit, v_lo, v_hi)`` with zeros
    in the lanes that miss.  The way of a hit is the first way that matches,
    as the reference's ``argmax`` over a bool mask (here over an int one).
    ``sets`` (int64, each key's set) skips the hash when the caller has it."""
    k_lo, k_hi, v_lo, v_hi, valid = cache_arrays
    s = hash64_32(lo, hi, _SET_SEED) & (nsets - 1) if sets is None else sets
    hitw = ((k_lo[s] == lo[:, None]) & (k_hi[s] == hi[:, None])
            & (valid[s] != 0))
    hit = hitw.any(dim=-1)
    way = torch.argmax(hitw.to(torch.int32), dim=-1)
    vlo = torch.where(hit, v_lo[s, way], 0)
    vhi = torch.where(hit, v_hi[s, way], 0)
    return hit, vlo, vhi


def neg_probe(lo, hi, neg_arrays, nneg, *, slots=None):
    """Direct-mapped negative-cache probe -> bool 'known absent' mask.
    ``slots`` (int64, each key's slot) skips the hash when the caller has
    it."""
    nk_lo, nk_hi, nvalid = neg_arrays
    n = hash64_32(lo, hi, _NEG_SEED) & (nneg - 1) if slots is None else slots
    return (nk_lo[n] == lo) & (nk_hi[n] == hi) & (nvalid[n] != 0)


class ShardedCNCache:
    """Per-device replicas of a ``CNKeyCache`` for the sharded Get path.

    Every device of the mesh is a compute node holding its own copy of the
    host-maintained cache arrays: ``repro_torch.core.sharded_kvs.
    place_cache`` copies one replica onto each rank's device."""

    def __init__(self, cache: CNKeyCache, ndev: int):
        self.cache = cache
        self.ndev = int(ndev)

    @property
    def nsets(self) -> int:
        return self.cache.nsets

    def arrays(self):
        return tuple(a.unsqueeze(0).expand((self.ndev,) + tuple(a.shape))
                     .clone() for a in self.cache.arrays())

    def memory_bytes_total(self) -> int:
        return self.cache.memory_bytes() * self.ndev
