"""Outback store: extendible hashing directory + the resize protocol (§4.4).

The port of ``repro.core.store``.  The directory is the paper's additional
hash layer (Fig. 7): ``2^global_depth`` entries, each pointing at one DMPH
table (an ``OutbackShard`` on the store's device) with a local depth.  A key
routes by the low ``global_depth`` bits of a dedicated directory hash,
computed on the host over the batch's keys.  When a table's overflow cache
crosses ``s_slow`` the store *splits* it:

  1. PRE_RESIZE is broadcast to the shard's compute nodes (the messages and
     the one-sided RC setup are metered as §4.4 describes);
  2. a new pair of DMPH tables is rebuilt from the live pairs (on the host,
     then moved to the device, as every build of the port) — Get/Update keep
     being served from the stale table during the rebuild, Insert/Delete get
     FALSE'd and buffered (replayed after the swap);
  3. compute nodes fetch the new locator via one-sided reads of the
     registered area ``(N_cNode, len, GlobalD, seeds, A, B)`` — the exact
     byte volume is metered — and decrement ``N_cNode`` (FAA);
  4. the stale table is dropped, cached entries routed to the successors
     are invalidated, and buffered mutations are replayed.

Given the same keys, values and op stream, the store gives the reference's
answers, meter totals, resize events (less their wall-clock
``rebuild_seconds``), directory and per-table MN images.  A
``transport=`` (``repro_torch.net.Transport``) is shared by the directory
meter and every table's, split successors included, and ``begin_split``
drops its ``mark_resize``, so the trace is the reference's too.  A lease
guard (:meth:`set_lease`) and a telemetry wire-sink factory
(:meth:`bind_table_sinks`) reach every table, split successors and tables
rebuilt by a resync included.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import ludo
from repro_torch.core import othello as othello_mod
from repro_torch.core.cn_cache import CNKeyCache
from repro_torch.core.hashing import hash64_32, split_u64, splitmix64
from repro_torch.core.meter import MSG_BYTES, CommMeter
from repro_torch.core.outback import (OutbackShard, cached_get,
                                      meter_cache_batch, resolve_device)

_DIR_SEED = 0xD14EC7


@dataclasses.dataclass
class ResizeEvent:
    step: int  # op index at which the resize happened
    table_keys: int
    rebuild_seconds: float
    locator_bytes: int  # one-sided fetch volume per compute node
    buffered_mutations: int


def _dir_hash(keys: np.ndarray) -> np.ndarray:
    """The directory hash of uint64 keys, as host int64."""
    lo, hi = split_u64(keys)
    return hash64_32(torch.from_numpy(lo.astype(np.int64)),
                     torch.from_numpy(hi.astype(np.int64)),
                     _DIR_SEED).numpy()


class OutbackStore:
    """Directory of Outback DMPH tables with runtime resizing.

    ``device=None`` means CUDA, and raises when there is no card; every
    table (and the internal CN cache, when ``cn_cache_budget_bytes`` asks
    for one) lives on ``device``."""

    def __init__(self, keys: np.ndarray, values: np.ndarray, *,
                 load_factor: float = 0.85, initial_depth: int = 0,
                 num_compute_nodes: int = 2, rng_seed: int = 0,
                 cn_cache_budget_bytes: int = 0, transport=None,
                 device=None):
        self.device = resolve_device(device)
        self._setup(load_factor, num_compute_nodes, initial_depth, rng_seed,
                    transport)
        # Every compute node gets the same fixed cache budget; the store
        # models one CN's view (tables are shared, so one cache suffices).
        self.cn_cache = (CNKeyCache(cn_cache_budget_bytes, device=self.device)
                         if cn_cache_budget_bytes else None)
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        dir_idx = _dir_hash(keys) & ((1 << initial_depth) - 1)
        for e in range(1 << initial_depth):
            m = dir_idx == e
            self.tables.append(OutbackShard(keys[m], values[m],
                                            load_factor=load_factor,
                                            rng_seed=rng_seed + e,
                                            transport=transport,
                                            device=self.device))
            self.local_depth.append(initial_depth)
        # directory[i] -> table index (tables may be shared across entries)
        self.directory = list(range(1 << initial_depth))

    def _setup(self, load_factor, num_compute_nodes, global_depth,
               rng_seed, transport) -> None:
        self.load_factor = load_factor
        self.num_compute_nodes = num_compute_nodes
        self.global_depth = global_depth
        self.rng_seed = rng_seed
        self.transport = transport  # shared by the directory meter and
        self.meter = CommMeter()    # every table's
        self.meter.sink = transport
        self.resize_events: list[ResizeEvent] = []
        self._op_count = 0
        # externally-owned CN caches (the api stack's) that must see the
        # same split-time invalidation the internal cache gets
        self._coherence_caches: list[CNKeyCache] = []
        self.local_depth: list[int] = []
        self.tables: list[OutbackShard] = []
        self.directory: list[int] = []
        self._buffer: list = []
        self._open_split = None
        self._lease = None  # optional lease guard, pushed to every table
        # optional telemetry wire-sink factory (repro_torch.obs): index ->
        # sink, re-applied to split successors and resynced tables so
        # per-table wire stats survive §4.4 splits and replica re-installs
        self._sink_factory = None

    @classmethod
    def from_reference(cls, directory, local_depth, global_depth, tables, *,
                       device=None, load_factor: float = 0.85,
                       num_compute_nodes: int = 2, rng_seed: int = 0,
                       op_count: int = 0, cn_cache: CNKeyCache | None = None,
                       transport=None) -> "OutbackStore":
        """A store that continues exactly as a ``repro`` store would, from
        that store's directory, local and global depths and, for each of its
        tables, ``(cn, mn_state)``: the CN half as numpy
        (``OutbackShard.from_reference_arrays``'s dict) and its
        ``mn_state()``.  ``rng_seed`` and ``op_count`` (its ops so far) keep
        later splits' seeds and resize steps in step; ``cn_cache`` is an
        internal cache to carry across (``CNKeyCache.from_reference_state``),
        ``transport`` a trace recorder for every meter.  The meters start at
        zero."""
        st = cls.__new__(cls)
        st.device = resolve_device(device)
        st._setup(load_factor, num_compute_nodes, int(global_depth), rng_seed,
                  transport)
        st.cn_cache = cn_cache
        st._op_count = int(op_count)
        st.directory = [int(t) for t in directory]
        st.local_depth = [int(d) for d in local_depth]
        st.tables = [OutbackShard.from_reference_arrays(
            cn, mn, device=st.device, load_factor=load_factor,
            transport=transport) for cn, mn in tables]
        return st

    # ------------------------------------------------------------- routing
    def _entry(self, key: int) -> int:
        h = int(_dir_hash(np.uint64([key]))[0])
        return h & ((1 << self.global_depth) - 1)

    def _table(self, key: int) -> OutbackShard:
        return self.tables[self.directory[self._entry(key)]]

    def _route_tables(self, keys: np.ndarray) -> np.ndarray:
        """Vectorised directory routing: key -> owning table index."""
        e = _dir_hash(keys) & ((1 << self.global_depth) - 1)
        return np.asarray(self.directory, dtype=np.int64)[e]

    # ------------------------------------------------------------ data ops
    def get(self, key: int):
        self._op_count += 1
        if self.cn_cache is None:
            return self._table(key).get(key)
        return cached_get(self.cn_cache, self.meter, key,
                          lambda k: self._table(k).get(k))

    def update(self, key: int, value: int) -> bool:
        self._op_count += 1
        ok = self._table(key).update(key, value)
        if ok and self.cn_cache is not None:
            self.cn_cache.note_update(key, value)
        return ok

    def delete(self, key: int) -> bool:
        self._op_count += 1
        t = self._table(key)
        if t.frozen:
            self._buffer.append(("delete", key, 0))
            return False
        ok = t.delete(key)
        if ok and self.cn_cache is not None:
            self.cn_cache.note_delete(key)
        return ok

    def insert(self, key: int, value: int) -> str:
        self._op_count += 1
        t = self._table(key)
        if t.frozen:
            # Paper: FALSE status; MN buffers and replays post-resize.
            self._buffer.append(("insert", key, value))
            self.meter.add(rts=1, req=MSG_BYTES, resp=8)
            return "frozen"
        case = t.insert(key, value)
        if self.cn_cache is not None:
            self.cn_cache.note_insert(key, value)
        if t.needs_resize() and self._open_split is None:
            self._split(self.directory[self._entry(key)])
        return case

    # ------------------------------------------------- batched write path
    # Mirrors the scalar ops lane-for-lane: vectorised directory routing,
    # per-table sub-batches served by the shard's batched protocol, frozen
    # tables buffering (with the same FALSE'd accounting), and the §4.4
    # split trigger evaluated between chunks (the scalar stream checks
    # after every insert; the chunk is the granularity a doorbell-batched
    # CN naturally observes).  The chunk never exceeds a third of the
    # table's overflow capacity, so a batch cannot sail from below the
    # ``s_slow`` trigger past the ``s_stop`` hard limit between two
    # checks.  After a split the remaining lanes re-route through the new
    # directory.

    SPLIT_CHECK_CHUNK = 256

    def _insert_chunk_len(self, table: OutbackShard) -> int:
        return max(1, min(self.SPLIT_CHECK_CHUNK,
                          int(0.35 * table.overflow.cap)))

    def insert_batch(self, keys: np.ndarray, values: np.ndarray) -> list[str]:
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        n = int(keys.shape[0])
        self._op_count += n
        statuses: list[str | None] = [None] * n
        done = np.zeros(n, dtype=bool)
        while not bool(done.all()):
            remaining = np.nonzero(~done)[0]
            tbl = self._route_tables(keys[remaining])
            resized = False
            for t in np.unique(tbl):
                lanes = remaining[tbl == t]
                table = self.tables[int(t)]
                if table.frozen:
                    # Paper: FALSE status; MN buffers and replays post-resize.
                    for i in lanes:
                        self._buffer.append(("insert", int(keys[i]),
                                             int(values[i])))
                        statuses[i] = "frozen"
                    self.meter.add(int(lanes.size), rts=1, req=MSG_BYTES,
                                   resp=8)
                    done[lanes] = True
                    continue
                if table.needs_resize() and self._open_split is None:
                    self._split(int(t))
                    resized = True
                    break
                step = self._insert_chunk_len(table)
                for c0 in range(0, int(lanes.size), step):
                    chunk = lanes[c0:c0 + step]
                    cases = table.insert_batch(keys[chunk], values[chunk])
                    for i, case in zip(chunk, cases):
                        statuses[i] = case
                    done[chunk] = True
                    if self.cn_cache is not None:
                        self.cn_cache.note_insert_batch(keys[chunk],
                                                        values[chunk])
                    if table.needs_resize() and self._open_split is None:
                        self._split(int(t))
                        resized = True
                        break
                if resized:
                    break  # directory changed: re-route the rest
        return statuses

    def update_batch(self, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        n = int(keys.shape[0])
        self._op_count += n
        ok = np.zeros(n, dtype=bool)
        tbl = self._route_tables(keys)
        for t in np.unique(tbl):
            m = tbl == t
            ok[m] = self.tables[int(t)].update_batch(keys[m], values[m])
        if self.cn_cache is not None:
            self.cn_cache.note_update_batch(keys[ok], values[ok])
        return ok

    def delete_batch(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        n = int(keys.shape[0])
        self._op_count += n
        ok = np.zeros(n, dtype=bool)
        tbl = self._route_tables(keys)
        for t in np.unique(tbl):
            m = tbl == t
            table = self.tables[int(t)]
            if table.frozen:
                for i in np.nonzero(m)[0]:
                    self._buffer.append(("delete", int(keys[i]), 0))
                continue
            ok[m] = table.delete_batch(keys[m])
        if self.cn_cache is not None:
            self.cn_cache.note_delete_batch(keys[ok])
        return ok

    def get_batch(self, keys: np.ndarray, *,
                  resolve_makeup: bool | None = None):
        """Vectorised Get across the directory -> (v_lo, v_hi, match)
        tensors on the store's device.

        With a CN cache, the batch is probed on the device; hit lanes are
        answered locally and only misses are dispatched to the tables.
        ``resolve_makeup`` mirrors ``OutbackShard.get_batch``: the default
        (``None``) resolves mismatched lanes through the Makeup-Get only
        when a cache is attached; pass ``True`` to force the full §4.3.1
        protocol on the cache-less path too (the api adapters do)."""
        keys = np.asarray(keys, dtype=np.uint64)
        self._op_count += len(keys)
        if self.cn_cache is None:
            return self._get_batch_tables(keys,
                                          resolve_makeup=bool(resolve_makeup))
        lo, hi = split_u64(keys)
        hit, neg, v_lo, v_hi = self.cn_cache.probe_batch(lo, hi)
        hit_h, neg_h = torch.stack([hit, neg]).cpu().numpy()
        meter_cache_batch(self.meter, int(hit_h.sum()), int(neg_h.sum()))
        match = hit.clone()
        mi = np.nonzero(~hit_h & ~neg_h)[0]
        if mi.size:
            m_lo, m_hi, m_match = self._get_batch_tables(keys[mi],
                                                         resolve_makeup=True)
            mi_t = torch.from_numpy(mi).to(self.device)
            v_lo[mi_t], v_hi[mi_t], match[mi_t] = m_lo, m_hi, m_match
        # full-batch observation: hit lanes keep their sketch counts and
        # CLOCK ref bits fresh, or the hot set would decay and churn
        self.cn_cache.observe_batch(lo, hi, v_lo, v_hi, match, hit_h, neg_h)
        return v_lo, v_hi, match

    def _get_batch_tables(self, keys: np.ndarray,
                          resolve_makeup: bool = False):
        """Dispatch a key batch to the owning DMPH tables (the MN path)."""
        if len(self.tables) == 1:
            return self.tables[0].get_batch(keys,
                                            resolve_makeup=resolve_makeup)
        n = keys.shape[0]
        v_lo = torch.zeros(n, dtype=torch.int32, device=self.device)
        v_hi = torch.zeros(n, dtype=torch.int32, device=self.device)
        match = torch.zeros(n, dtype=torch.bool, device=self.device)
        tbl = self._route_tables(keys)
        for t in np.unique(tbl):
            m = np.nonzero(tbl == t)[0]
            lo, hi, mt = self.tables[int(t)].get_batch(
                keys[m], resolve_makeup=resolve_makeup)
            idx = torch.from_numpy(m).to(self.device)
            v_lo[idx], v_hi[idx], match[idx] = lo, hi, mt
        return v_lo, v_hi, match

    # -------------------------------------------------------------- resize
    def _split(self, t_idx: int) -> None:
        h = self.begin_split(t_idx)
        h.build()
        h.finish()

    def begin_split(self, t_idx: int) -> "SplitHandle":
        """Freeze the table and open a resize window (PRE_RESIZE phase).

        Callers interleave data ops between ``begin_split`` and ``finish``
        to reproduce the paper's throughput-during-resize study (Fig. 17):
        Gets/Updates keep hitting the stale table, Inserts/Deletes are
        FALSE'd and buffered."""
        if self._open_split is not None:
            raise RuntimeError("a resize is already in flight")
        depth = self.local_depth[t_idx]
        if depth == self.global_depth:
            # Double the directory (paper Fig. 7, GlobalD += 1).
            self.directory = self.directory + list(self.directory)
            self.global_depth += 1
        # PRE_RESIZE broadcast + RC setup with every compute node.
        self.meter.add(self.num_compute_nodes, rts=1, req=MSG_BYTES, resp=8)
        if self.transport is not None:
            # the rebuild steals MN CPU share for its duration (§4.4) —
            # the simulator turns this into a throughput-dip window
            self.transport.mark_resize(self.tables[t_idx].n_keys)
        self.tables[t_idx].frozen = True
        self._buffer = []
        h = SplitHandle(self, t_idx, depth)
        self._open_split = h
        return h

    def _finish_split(self, h: "SplitHandle") -> None:
        t_idx, depth = h.t_idx, h.depth
        # One-sided locator fetch by every compute node (§4.4): polls of
        # (N_cNode, len), the bulk read, and the FAA decrement — RDMA READ
        # payloads, not RPC messages, so no message padding applies.  A
        # locator is its uint8 seeds and uint32 Othello words.
        per_cn = sum(8 + 8 + 8 + t.cn.memory_bytes() for t in (h.t_lo, h.t_hi))
        self.meter.add(self.num_compute_nodes, rts=3, req=16, resp=per_cn,
                       one_sided=True)

        # swap directory pointers (the successors inherit the lease guard
        # and, when telemetry is on, per-table wire sinks at their new
        # directory indices)
        h.t_lo.lease = h.t_hi.lease = self._lease
        self.tables.append(h.t_hi)
        hi_idx = len(self.tables) - 1
        self.tables[t_idx] = h.t_lo
        if self._sink_factory is not None:
            h.t_lo.meter.add_sink(self._sink_factory(t_idx))
            h.t_hi.meter.add_sink(self._sink_factory(hi_idx))
        self.local_depth[t_idx] = depth + 1
        self.local_depth.append(depth + 1)
        for e in range(len(self.directory)):
            if self.directory[e] == t_idx and (e >> depth) & 1:
                self.directory[e] = hi_idx

        # CN-cache coherence: entries filled from the stale table during the
        # resize window may be newer than the rebuilt tables (a §4.4 Update
        # races the snapshot), so drop everything now routed to either
        # successor — the same sync point at which CNs fetch the new locator.
        # Externally-bound caches (the api stack's) join the same sync.
        for c in (self.cn_cache, *self._coherence_caches):
            if c is None:
                continue
            dir_mask = (1 << self.global_depth) - 1
            directory = torch.tensor(self.directory, dtype=torch.int64,
                                     device=c.device)

            def routed_to_successors(k_lo, k_hi, directory=directory):
                t = directory[hash64_32(k_lo, k_hi, _DIR_SEED) & dir_mask]
                return (t == t_idx) | (t == hi_idx)

            c.invalidate_where(routed_to_successors)

        buffered, self._buffer = self._buffer, []
        self._open_split = None
        self.resize_events.append(ResizeEvent(
            self._op_count, h.n_live, h.rebuild_seconds, per_cn, len(buffered)))
        for op, k, v in buffered:  # replay on the fresh tables
            if op == "insert":
                self.insert(k, v)
            else:
                self.delete(k)

    def bind_coherence_cache(self, cache: CNKeyCache) -> None:
        """Register an externally-owned CN cache (the api stack's) for
        split-time invalidation, without routing any data path through it —
        the middleware owns probe/fill, the store owns the sync point."""
        self._coherence_caches.append(cache)

    # --------------------------------------------------------- replication
    def set_lease(self, lease) -> None:
        """Install a lease guard on every table, present and future.

        The guard's ``on_seed_refresh`` fires before any Makeup-Get seed
        refresh (``repro_torch.core.outback``); split successors inherit it
        in ``_finish_split``, and tables rebuilt by
        :meth:`install_mn_state` get it too.  ``None`` detaches."""
        self._lease = lease
        for t in self.tables:
            t.lease = lease

    # ----------------------------------------------------------- telemetry
    def bind_table_sinks(self, factory) -> None:
        """Attach a per-table telemetry wire sink, present and future.

        ``factory(table_index)`` must return an object implementing the
        meter-sink protocol (``on_meter_add``); it is applied to every
        current table's meter and — like :meth:`set_lease` — re-applied
        to §4.4 split successors (at the directory index they take) and
        to tables rebuilt by a replica resync.  Sinks are observers: the
        meters' accounting and the transport trace are byte-identical
        with or without them."""
        self._sink_factory = factory
        if factory is None:
            return
        seen = set()
        for i, t in enumerate(self.tables):
            if id(t) not in seen:  # a table may sit at several indices
                seen.add(id(t))
                t.meter.add_sink(factory(i))

    # ------------------------------------------------------------ MN image
    def mn_state(self) -> dict:
        """Host image of the whole directory store's MN half: per-table
        ``OutbackShard.mn_state`` images plus the directory, and a host copy
        of each table's locator so a replica that slept through a §4.4 split
        can re-materialise the successor tables it never built.  Every
        array is numpy and every scalar a Python ``int``, in the reference's
        layout and dtypes, so the image hashes as the reference's does
        (``repro_torch.net.chaos.state_signature``)."""
        return {"global_depth": self.global_depth,
                "local_depth": list(self.local_depth),
                "directory": list(self.directory),
                "tables": [{"cn": _host_cn(t.cn),
                            "mn": t.mn_state(),
                            "load_factor": t.load_factor}
                           for t in self.tables]}

    def install_mn_state(self, state: dict) -> None:
        """Overwrite this store with another's :meth:`mn_state`.

        Matching table layouts install in place; a layout mismatch rebuilds
        the tables list from the shipped images (this package's or the
        reference's).  Coherence-cache registrations, the lease guard and
        the telemetry sink factory survive either way."""
        same_layout = (
            len(state["tables"]) == len(self.tables)
            and state["global_depth"] == self.global_depth
            and all(tuple(st["mn"]["slots_lo"].shape)
                    == tuple(t.slots_lo.shape)
                    for st, t in zip(state["tables"], self.tables)))
        if same_layout:
            for st, t in zip(state["tables"], self.tables):
                t.install_mn_state(st["mn"])
        else:
            self.tables = [
                OutbackShard._from_state(_device_cn(st["cn"], self.device),
                                         st["mn"],
                                         load_factor=st["load_factor"],
                                         transport=self.transport)
                for st in state["tables"]]
            for i, t in enumerate(self.tables):
                t.lease = self._lease
                if self._sink_factory is not None:
                    t.meter.add_sink(self._sink_factory(i))
        self.global_depth = int(state["global_depth"])
        self.local_depth = list(state["local_depth"])
        self.directory = list(state["directory"])
        self._open_split = None
        self._buffer = []

    def mn_state_bytes(self) -> int:
        """On-wire size of one replica resync (MN half only)."""
        return sum(t.mn_state_bytes() for t in self._unique_tables())

    # --------------------------------------------------------- accounting
    def _unique_tables(self):
        seen = set()
        for t in self.tables:
            if id(t) not in seen:  # a table may sit at several indices
                seen.add(id(t))
                yield t

    @property
    def n_keys(self) -> int:
        return sum(t.n_keys for t in self._unique_tables())

    def cn_memory_bytes(self) -> int:
        """Per-compute-node memory: every CN caches all live locators plus
        its (fixed-budget) hot-key cache."""
        total = sum(t.cn_memory_bytes() for t in self._unique_tables())
        if self.cn_cache is not None:
            total += self.cn_cache.memory_bytes()
        return total

    def meter_total(self) -> CommMeter:
        m = CommMeter()
        m.merge(self.meter)
        for t in self._unique_tables():
            m.merge(t.meter)
        return m


def _host_cn(cn: ludo.LudoCN) -> ludo.LudoCN:
    """A host image of a CN locator in the reference's layout: uint32
    Othello words and uint8 seeds as numpy arrays, sizes and seeds as
    Python ints."""
    oth = cn.othello

    def words(w):
        return w.cpu().numpy().view(np.uint32).copy()

    host = othello_mod.Othello(words(oth.words_a), words(oth.words_b),
                               int(oth.ma), int(oth.mb), int(oth.seed_a),
                               int(oth.seed_b))
    return ludo.LudoCN(host, cn.seeds.cpu().numpy().copy(),
                       int(cn.num_buckets))


def _device_cn(image, device) -> ludo.LudoCN:
    """A locator on ``device`` from a host image (:func:`_host_cn`'s, or
    the reference's, which has the same fields)."""
    oth = image.othello

    def words(w):
        a = np.array(w, dtype=np.uint32)
        return torch.from_numpy(a.view(np.int32)).to(device)

    dev_oth = othello_mod.Othello(words(oth.words_a), words(oth.words_b),
                                  int(oth.ma), int(oth.mb), int(oth.seed_a),
                                  int(oth.seed_b))
    seeds = torch.from_numpy(np.array(image.seeds, dtype=np.uint8))
    return ludo.LudoCN(dev_oth, seeds.to(device), int(image.num_buckets))


class SplitHandle:
    """An in-flight table split: freeze -> build -> finish (swap + replay)."""

    def __init__(self, store: OutbackStore, t_idx: int, depth: int):
        self.store, self.t_idx, self.depth = store, t_idx, depth
        self.t_lo = self.t_hi = None
        self.n_live = 0
        self.rebuild_seconds = 0.0

    def build(self) -> None:
        """Rebuild the two successor DMPH tables (the slow part: the host
        Ludo build, then the arrays to the device — the paper measures
        ~3 s for 20M keys on a single MN thread)."""
        store, depth = self.store, self.depth
        table = store.tables[self.t_idx]
        t0 = time.perf_counter()
        keys, vals = table.live_pairs()
        side = (_dir_hash(keys) >> depth) & 1 != 0
        # Extendible hashing (Fig. 7): each successor inherits the PARENT's
        # table geometry, so a split genuinely halves the load and buys real
        # insert headroom (content-sized successors re-trigger immediately).
        nb = table.cn.num_buckets
        seed = store.rng_seed + 101 * len(store.tables)
        self.t_lo = OutbackShard(keys[~side], vals[~side],
                                 load_factor=store.load_factor,
                                 num_buckets=nb, rng_seed=seed,
                                 transport=store.transport,
                                 device=store.device)
        self.t_hi = OutbackShard(keys[side], vals[side],
                                 load_factor=store.load_factor,
                                 num_buckets=nb, rng_seed=seed + 1,
                                 transport=store.transport,
                                 device=store.device)
        if store.device.type == "cuda":
            torch.cuda.synchronize(store.device)
        self.n_live = int(keys.shape[0])
        self.rebuild_seconds = time.perf_counter() - t0

    def finish(self) -> None:
        self.store._finish_split(self)


def make_uniform_keys(n: int, seed: int = 1) -> np.ndarray:
    """Deterministic unique 64-bit key set (FB/OSM-style random IDs)."""
    keys = splitmix64(np.arange(1, int(n * 1.05) + 16, dtype=np.uint64)
                      + np.uint64(seed << 32))
    keys = np.unique(keys)[:n]
    if keys.shape[0] != n:
        raise RuntimeError(f"splitmix64 gave fewer than {n} unique keys")
    return keys
