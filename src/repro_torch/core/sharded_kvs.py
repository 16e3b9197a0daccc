"""Distributed Outback over a mesh of ranks: the paper's pools as mesh axes.

The port of ``repro.core.sharded_kvs``.  A mesh ``(data=D, model=M)`` is a
``torch.distributed`` world of ``D*M`` ranks (:func:`make_mesh`); rank ``r``
is the device ``(d, m) = divmod(r, M)``, the order in which the reference's
``P(("data", "model"))`` hands out query chunks and cache replicas.

Placement:

* shard ``m``'s **CN component** (Othello + seeds) is replicated down mesh
  column ``m`` — every rank in the column is one of the shard's compute
  nodes caching the locator;
* shard ``m``'s **MN component** (DMPH buckets + heap) is *range-sharded over
  the column's D ranks*: rank ``(d, m)`` holds bucket rows and heap rows
  ``d`` of shard ``m``.  The heap is re-ordered at build time so every
  bucket's KV blocks live on the bucket's own row (one-touch locality).

A batched Get is the paper's message flow, with collectives as the network
(each ``all_to_all`` is ``torch.distributed.all_to_all_single`` over the
axis's group: NCCL for card tensors, gloo for CPU ones):

  0. (optional) CN-cache probe: each rank probes its ``ShardedCNCache``
     replica; hit lanes are answered locally and marked with an
     out-of-range bin target so they never enter the routing bins;
  1. service-layer routing: bin by key-shard, ``all_to_all`` over ``model``
     (the key's two lanes in one exchange);
  2. CN compute on the receiving rank: the ``ludo_lookup`` kernel with the
     shard's Othello seeds -> (bucket, slot);
  3. **the one round trip**: bin by bucket range, ``all_to_all`` over
     ``data`` carrying (bucket, slot); the owning sub-MN gathers the slot
     word, decodes it with the ``slot_unpack`` kernel and gathers the heap
     block — zero hashes, zero compares;
  4. response ``all_to_all``s retrace the route; the CN full-key check runs
     at the origin.

``variant='race'`` is the one-sided baseline on the same substrate: two
dependent gather phases over ``data`` (bucket-group fetch, CN-side slot
selection and decode, then heap fetch).

Routing uses fixed per-bin capacity (MoE-style) so every exchange has equal
splits; empty lanes carry the sentinel key, and a lane a full bin drops
comes back as the sentinel in all four fields, unmatched.  The build and
the stacked state stay on the host (numpy, the reference's dtypes), so the
two packages reach identical arrays from the same inputs.  Lanes on the
device are int32 tensors holding uint32 bit patterns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.baselines import RaceKVS
from repro_torch.core.cn_cache import ShardedCNCache, cache_probe
from repro_torch.core.hashing import hash64_32, hash64_32_np, split_u64
from repro_torch.core.ludo import SEED_BUCKET_A, SEED_BUCKET_B
from repro_torch.core.meter import CommMeter
from repro_torch.core.outback import (GET_REQ_BYTES, KV_BLOCK_BYTES,
                                      OutbackShard, meter_cache_batch,
                                      resolve_device)
from repro_torch.core.slots import LEN_MASK, LEN_SHIFT
from repro_torch.kernels import ops

_ROUTE_SEED = 0x50A7ED
SENT = 0xFFFFFFFF  # sentinel key lane (no real key hashes to all-ones twice)
_SENT32 = -1  # SENT as an int32 lane
AXES = ("data", "model")
# what each device type's tensors need from the process group's backend
_BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


# ---------------------------------------------------------------------------
# the mesh


class RankMesh:
    """This rank's view of a ``(data, model)`` mesh of ranks.

    ``shape`` is ``{"data": D, "model": M}``; ``coords`` this rank's
    ``(d, m)``; ``groups`` the process groups of its ``data`` column (the
    ranks of the same ``m``) and of its ``model`` row (same ``d``), in
    which a rank's group rank is its ``d`` and its ``m``."""

    def __init__(self, shape: dict, rank: int, device: torch.device,
                 groups: dict):
        self.shape = dict(shape)
        self.rank = int(rank)
        self.device = device
        self.groups = dict(groups)

    @property
    def coords(self) -> tuple[int, int]:
        return divmod(self.rank, self.shape["model"])

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Chunk ``j`` of ``x``'s leading axis goes to the rank at index
        ``j`` of ``axis``; chunk ``j`` of the result came from it.  Always a
        collective over the axis's group (also at size 1), issued
        synchronously: the caller's next op on the device stream waits."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.groups[axis])
        return out


def _backends() -> dict:
    """``{device type: backend}`` of the default process group."""
    return dict(part.split(":") for part in
                dist.get_backend_config().split(","))


def make_mesh(axis_shapes, axis_names=AXES, *, device=None) -> RankMesh:
    """The counterpart of ``jax.make_mesh(axis_shapes, ("data", "model"))``
    over the initialized default process group, whose world size must be
    ``D*M``.  Every rank must call it, with the same shape: it creates one
    group for each ``model`` row, then one for each ``data`` column.

    ``device=None`` means CUDA (``cuda:<rank % cards>``, made current) and
    raises without a card; pass ``device="cpu"`` for CPU ranks.  The
    group's backend must serve the device's tensors: NCCL for CUDA, gloo
    for the CPU (``"cpu:gloo,cuda:nccl"`` serves both)."""
    if tuple(axis_names) != AXES:
        raise ValueError(f"mesh axes must be {AXES}, got {tuple(axis_names)}")
    D, M = (int(s) for s in axis_shapes)
    if D < 1 or M < 1:
        raise ValueError(f"mesh shape must be positive, got {(D, M)}")
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != D * M:
        raise ValueError(f"mesh {(D, M)} needs {D * M} ranks, the process "
                         f"group has {world}")
    want = _BACKEND_OF.get(device.type)
    have = _backends().get(device.type)
    if want is None or have != want:
        raise RuntimeError(
            f"the process group serves {device.type} tensors with "
            f"{have or 'no backend'}; the mesh needs {want or 'cpu or cuda'}"
            f" (init_process_group('cpu:gloo,cuda:nccl') serves both)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    d, m = divmod(rank, M)
    groups = {}
    for row in range(D):  # every rank creates every group, in this order
        g = dist.new_group([row * M + j for j in range(M)])
        if row == d:
            groups["model"] = g
    for col in range(M):
        g = dist.new_group([i * M + col for i in range(D)])
        if col == m:
            groups["data"] = g
    return RankMesh({"data": D, "model": M}, rank, device, groups)


# ---------------------------------------------------------------------------
# the stacked state


@dataclasses.dataclass
class ShardedKVSState:
    """Stacked host arrays for M shards, ready to be placed on a mesh."""

    # CN component, replicated over 'data' (rank (d, m) takes row m)
    words_a: np.ndarray  # (M, WA) uint32
    words_b: np.ndarray  # (M, WB) uint32
    seeds: np.ndarray  # (M, NB) uint8
    oth_meta: np.ndarray  # (M, 4) int64: seed_a, seed_b (per-shard retries)
    # MN component, range-sharded over 'data' (rank (d, m): shard m, rows d)
    slots_lo: np.ndarray  # (M, NB, 4) uint32
    slots_hi: np.ndarray  # (M, NB, 4) uint32
    heap_klo: np.ndarray  # (M, CAP) uint32
    heap_khi: np.ndarray
    heap_vlo: np.ndarray
    heap_vhi: np.ndarray
    num_buckets: int  # per shard (padded to a multiple of D)
    heap_cap: int  # per shard (padded to a multiple of D)
    ma: int  # othello geometry, equal across shards
    mb: int
    # transport seam: set by build_sharded(transport=...); make_get_fn then
    # returns a wrapper that meters every batched Get into it
    meter: CommMeter | None = None
    # the OutbackShard objects the state was stacked from, kept only when
    # build_sharded(keep_shards=True): the 'sharded' adapter serves the full
    # protocol through them and re-installs dirty shards into the state
    shards: list | None = None

    def arrays(self):
        return (self.words_a, self.words_b, self.seeds, self.oth_meta,
                self.slots_lo, self.slots_hi, self.heap_klo, self.heap_khi,
                self.heap_vlo, self.heap_vhi)

    def index_bytes_cn(self) -> int:
        return self.words_a.nbytes + self.words_b.nbytes + self.seeds.nbytes

    def index_bytes_mn(self) -> int:
        return self.slots_lo.nbytes + self.slots_hi.nbytes

    @classmethod
    def from_reference(cls, ref, *, transport=None) -> "ShardedKVSState":
        """A copy of a ``repro`` ``ShardedKVSState``'s arrays and geometry
        (no build, no kept shards), metering into ``transport`` when one is
        given: lockstep tests start both packages from one state."""
        arrays = {f: np.array(getattr(ref, f), copy=True) for f in
                  ("words_a", "words_b", "seeds", "oth_meta", "slots_lo",
                   "slots_hi", "heap_klo", "heap_khi", "heap_vlo",
                   "heap_vhi")}
        return cls(**arrays, num_buckets=int(ref.num_buckets),
                   heap_cap=int(ref.heap_cap), ma=int(ref.ma),
                   mb=int(ref.mb), meter=_meter_into(transport))


def _meter_into(transport) -> CommMeter | None:
    if transport is None:
        return None
    meter = CommMeter()
    meter.sink = transport
    return meter


def build_sharded(keys: np.ndarray, values: np.ndarray, *, num_shards: int,
                  data_parallel: int, load_factor: float = 0.85,
                  heap_slack: float = 1.5, rng_seed: int = 0,
                  transport=None, keep_shards: bool = False,
                  device=None) -> ShardedKVSState:
    """Partition keys into ``num_shards`` equal-geometry Outback shards and
    stack their components for mesh placement (heap co-located per row).

    With ``transport`` (a ``repro_torch.net.Transport``), the state carries
    a CommMeter sinking into it and ``make_get_fn`` meters each batched Get.

    ``keep_shards=True`` retains the ``OutbackShard`` objects on
    ``state.shards``, on ``device`` (CUDA unless the caller passes
    ``device="cpu"``; their meters sink into ``transport`` too), so the
    ``sharded`` adapter can serve scalar protocol ops and mutations and
    re-stack mutated shards; otherwise the shards are built on the CPU and
    discarded."""
    keys = np.asarray(keys, dtype=np.uint64)
    values = np.asarray(values, dtype=np.uint64)
    lo, hi = split_u64(keys)
    shard_of = hash64_32_np(lo, hi, _ROUTE_SEED) % np.uint32(num_shards)

    n_max = max(int((shard_of == m).sum()) for m in range(num_shards))
    D = data_parallel
    nb = _round_up(max(D, int(np.ceil(n_max / (4.0 * load_factor)))), D)
    cap = _round_up(int(np.ceil(n_max * heap_slack)) + 4 * D, D)
    ma = int(np.ceil(1.33 * n_max)) + 7
    mb = int(np.ceil(1.00 * n_max)) + 11

    M = num_shards
    wa_words = (ma + 31) // 32
    wb_words = (mb + 31) // 32
    st = ShardedKVSState(
        meter=_meter_into(transport),
        words_a=np.zeros((M, wa_words), np.uint32),
        words_b=np.zeros((M, wb_words), np.uint32),
        seeds=np.zeros((M, nb), np.uint8),
        oth_meta=np.zeros((M, 4), np.int64),
        slots_lo=np.zeros((M, nb, 4), np.uint32),
        slots_hi=np.zeros((M, nb, 4), np.uint32),
        heap_klo=np.full((M, cap), SENT, np.uint32),
        heap_khi=np.full((M, cap), SENT, np.uint32),
        heap_vlo=np.zeros((M, cap), np.uint32),
        heap_vhi=np.zeros((M, cap), np.uint32),
        num_buckets=nb, heap_cap=cap, ma=ma, mb=mb)

    shard_device = resolve_device(device) if keep_shards else "cpu"
    kept = [] if keep_shards else None
    for m in range(M):
        mask = shard_of == m
        sh = OutbackShard(keys[mask], values[mask], load_factor=load_factor,
                          rng_seed=rng_seed + m, num_buckets=nb,
                          oth_ma=ma, oth_mb=mb, device=shard_device)
        _install_shard(st, m, sh, D)
        if kept is not None:
            sh.meter.sink = transport
            kept.append(sh)
    st.shards = kept
    return st


def _install_shard(st: ShardedKVSState, m: int, sh: OutbackShard,
                   D: int) -> None:
    """Copy one shard into the stacked state, re-ordering its heap so each
    bucket row's blocks live in that row's heap range."""
    oth = sh.cn.othello
    wa = oth.words_a.cpu().numpy().view(np.uint32)
    wb = oth.words_b.cpu().numpy().view(np.uint32)
    st.words_a[m, : wa.shape[0]] = wa
    st.words_b[m, : wb.shape[0]] = wb
    st.seeds[m] = sh.cn.seeds.cpu().numpy()
    st.oth_meta[m] = (oth.seed_a, oth.seed_b, 0, 0)

    mn = sh.mn_state()
    nb, cap = st.num_buckets, st.heap_cap
    per_row = cap // D
    lens = (mn["slots_hi"] >> np.uint32(LEN_SHIFT)) & np.uint32(LEN_MASK)
    b_idx, s_idx = np.nonzero(lens != 0)
    old_addr = mn["slots_lo"][b_idx, s_idx].astype(np.int64)
    rows = (b_idx // (nb // D)).astype(np.int64)
    order = np.argsort(rows, kind="stable")
    rows_s = rows[order]
    start = np.searchsorted(rows_s, np.arange(D))
    pos = np.arange(rows_s.size) - start[rows_s]
    if pos.size and int(pos.max()) >= per_row:
        raise ValueError("heap row overflow; raise heap_slack")
    new_addr = rows_s * per_row + pos

    src = old_addr[order]
    for name in ("heap_klo", "heap_khi", "heap_vlo", "heap_vhi"):
        getattr(st, name)[m, new_addr] = mn[name][src]
    st.slots_lo[m] = mn["slots_lo"]
    st.slots_hi[m] = mn["slots_hi"]
    st.slots_lo[m, b_idx[order], s_idx[order]] = new_addr.astype(np.uint32)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# routing helpers (MoE-style fixed-capacity binning), torch ops on the
# device of their inputs


def bin_by(tgt: torch.Tensor, nbins: int, cap: int) -> torch.Tensor:
    """Map a (B,)-batch of bin targets (>= 0) to (nbins*cap,) bin lanes.

    Returns ``idxmap`` (nbins*cap,) int32 of source positions (== B for
    empty lanes): gather through it to fill bins, scatter through it to
    un-bin.  Positions with ``tgt >= nbins`` never enter any bin, and a
    bin takes its first ``cap`` positions in batch order (the rest are
    dropped)."""
    B = tgt.shape[0]
    dev = tgt.device
    sorted_tgt, order = torch.sort(tgt.to(torch.int32), stable=True)
    order = order.to(torch.int32)
    start = torch.searchsorted(
        sorted_tgt, torch.arange(nbins, dtype=torch.int32, device=dev))
    in_range = sorted_tgt < nbins
    pos = torch.arange(B, dtype=torch.int32, device=dev) - start[
        torch.clamp(sorted_tgt, max=nbins - 1).long()].to(torch.int32)
    dest = torch.where((pos < cap) & in_range, sorted_tgt * cap + pos,
                       nbins * cap)
    # one spare lane takes every dropped position, then is cut off
    idxmap = torch.full((nbins * cap + 1,), B, dtype=torch.int32, device=dev)
    idxmap[dest.long()] = order
    return idxmap[:-1]


def take(arr: torch.Tensor, idxmap: torch.Tensor, fill: int) -> torch.Tensor:
    """Gather rows with ``fill`` for empty lanes (idx == B)."""
    B = arr.shape[0]
    safe = torch.clamp(idxmap, max=B - 1).long()
    empty = (idxmap >= B).reshape(idxmap.shape + (1,) * (arr.dim() - 1))
    return arr[safe].masked_fill_(empty, fill)


def unbin(idxmap: torch.Tensor, binned: torch.Tensor, out_len: int,
          fill: int = 0) -> torch.Tensor:
    """Scatter bin lanes back to original positions (``idxmap`` <=
    ``out_len``; empty lanes land in a spare row that is cut off)."""
    tmpl = torch.full((out_len + 1, *binned.shape[1:]), fill,
                      dtype=binned.dtype, device=binned.device)
    tmpl[idxmap.long()] = binned
    return tmpl[:out_len]


# ---------------------------------------------------------------------------
# the SPMD Get programs


def make_get_fn(mesh: RankMesh, st: ShardedKVSState, batch_per_device: int,
                *, capacity_slack: float = 2.0, variant: str = "outback",
                cache: ShardedCNCache | None = None):
    """Build this rank's batched Get for the mesh/state geometry.

    ``variant``: 'outback' (1 index RT) or 'race' (2 dependent index RTs,
    the one-sided analogue).  Returns ``(fn, (cap_m, cap_d))``; every rank
    of the mesh calls its ``fn`` together (the collectives pair up).

    ``fn(q_lo, q_hi, *state_blocks)`` takes the rank's ``batch_per_device``
    query lanes (int32 tensors on ``mesh.device``) and the rank's blocks
    from :func:`place_state`, and returns the rank's ``(v_lo, v_hi,
    match)`` — what the reference's ``shard_map`` body returns on this
    device.  With ``cache`` (see :func:`place_cache`), ``fn(q_lo, q_hi,
    *cache_blocks, *state_blocks)`` probes the rank's replica first (hit
    lanes never enter the routing bins) and also returns the hit mask.

    The shard's Othello seeds are read from ``st`` here, once.  With a
    meter on ``st`` (``build_sharded(transport=...)``) each call meters the
    rank's own lanes; the ranks' meters sum to the reference's."""
    if variant not in ("outback", "race"):
        raise ValueError(f"variant must be 'outback' or 'race', "
                         f"got {variant!r}")
    D = int(mesh.shape["data"])
    M = int(mesh.shape["model"])
    cap_m = _round_up(
        int(np.ceil(batch_per_device / max(M, 1) * capacity_slack)) + 1, 8)
    cap_d = _round_up(
        int(np.ceil(cap_m * M / max(D, 1) * capacity_slack)) + 1, 8)
    nb_per_row = st.num_buckets // D
    heap_per_row = st.heap_cap // D
    my_row, m = mesh.coords
    meta = dict(ma=st.ma, mb=st.mb, nb=st.num_buckets,
                seed_a=int(st.oth_meta[m, 0]), seed_b=int(st.oth_meta[m, 1]),
                seed_ba=SEED_BUCKET_A, seed_bb=SEED_BUCKET_B)
    a2a = mesh.all_to_all

    def mn_touch(slots_lo, slots_hi, h, b_loc, s_idx):
        """The memory-node work: two dependent gathers, zero compute."""
        h_klo, h_khi, h_vlo, h_vhi = h
        _, _, length, addr = ops.slot_unpack(slots_lo[b_loc, s_idx],
                                             slots_hi[b_loc, s_idx])
        a_loc = torch.clamp(addr - my_row * heap_per_row, 0,
                            heap_per_row - 1).long()
        empty = length == 0
        return (h_klo[a_loc].masked_fill_(empty, _SENT32),
                h_khi[a_loc].masked_fill_(empty, _SENT32),
                h_vlo[a_loc], h_vhi[a_loc])

    def spmd_get(q_lo, q_hi, *arrays):
        if cache is not None:
            cache_arrays = arrays[:5]
            arrays = arrays[5:]
        (words_a, words_b, seeds, _, slots_lo, slots_hi,
         h_klo, h_khi, h_vlo, h_vhi) = arrays
        B = q_lo.shape[0]

        # -- CN-cache probe: hits never enter the routing bins --------------
        shard = hash64_32(q_lo, q_hi, _ROUTE_SEED) % M
        if cache is not None:
            c_hit, c_vlo, c_vhi = cache_probe(q_lo, q_hi, cache_arrays,
                                              cache.nsets)
            shard = shard.masked_fill_(c_hit, M)

        # -- phase 0: service-layer routing to shard columns ('model') ------
        route_m = bin_by(shard, M, cap_m)
        q = take(torch.stack([q_lo, q_hi], -1), route_m, _SENT32)
        r = a2a(q.reshape(M, cap_m, 2), "model").reshape(-1, 2).t()
        r_lo, r_hi = r.contiguous().unbind(0)
        r_valid = ~((r_lo == _SENT32) & (r_hi == _SENT32))
        n = r_lo.shape[0]

        # -- CN compute (this rank is a CN of its column's shard) -----------
        bucket, slot = ops.ludo_lookup(r_lo, r_hi, words_a, words_b, seeds,
                                       meta)
        row = torch.clamp(torch.div(bucket, nb_per_row, rounding_mode="floor"),
                          max=D - 1)
        row = torch.where(r_valid, row, D - 1)

        if variant == "outback":
            # -- THE one round trip over 'data': send (bucket, slot) --------
            route_d = bin_by(row, D, cap_d)
            req = torch.stack([bucket, slot, r_lo, r_hi], -1)
            req = a2a(take(req, route_d, _SENT32).reshape(D, cap_d, 4),
                      "data").reshape(-1, 4)
            b_loc = torch.clamp(req[:, 0] - my_row * nb_per_row, 0,
                                nb_per_row - 1).long()
            s_idx = torch.clamp(req[:, 1], max=3).long()
            resp = torch.stack(mn_touch(slots_lo, slots_hi,
                                        (h_klo, h_khi, h_vlo, h_vhi),
                                        b_loc, s_idx), -1)
            resp = a2a(resp.reshape(D, cap_d, 4), "data").reshape(-1, 4)
            back = unbin(route_d, resp, n, _SENT32)
        else:  # -- 'race': two dependent one-sided gather phases ------------
            route_d = bin_by(row, D, cap_d)
            req = a2a(take(bucket, route_d, _SENT32).reshape(D, cap_d),
                      "data").reshape(-1)
            b_loc = torch.clamp(req - my_row * nb_per_row, 0,
                                nb_per_row - 1).long()
            grp = torch.stack([slots_lo[b_loc], slots_hi[b_loc]], -1)
            grp = a2a(grp.reshape(D, cap_d, 8), "data").reshape(-1, 4, 2)
            grp = unbin(route_d, grp, n, 0)
            # CN selects the slot from the fetched group and decodes it.
            lane = torch.arange(n, device=grp.device)
            pick = grp[lane, slot.long()]
            _, _, length, addr = ops.slot_unpack(pick[:, 0].contiguous(),
                                                 pick[:, 1].contiguous())
            # phase B: one-sided heap fetch from the row owning the address.
            hrow = torch.clamp(torch.div(addr, heap_per_row,
                                         rounding_mode="floor"), max=D - 1)
            live = r_valid & (length != 0)
            hrow = torch.where(live, hrow, D - 1)
            route_h = bin_by(hrow, D, cap_d)
            areq = a2a(take(addr, route_h, 0).reshape(D, cap_d),
                       "data").reshape(-1)
            a_loc = torch.clamp(areq - my_row * heap_per_row, 0,
                                heap_per_row - 1).long()
            blk = torch.stack([h_klo[a_loc], h_khi[a_loc],
                               h_vlo[a_loc], h_vhi[a_loc]], -1)
            blk = a2a(blk.reshape(D, cap_d, 4), "data").reshape(-1, 4)
            back = unbin(route_h, blk, n, _SENT32)
            back[:, 0].masked_fill_(~live, _SENT32)

        # -- back over 'model' to the origin CN, full-key check -------------
        resp_m = a2a(back.reshape(M, cap_m, 4), "model").reshape(-1, 4)
        final = unbin(route_m, resp_m, B, _SENT32)
        match = (final[:, 0] == q_lo) & (final[:, 1] == q_hi)
        if cache is None:
            return final[:, 2], final[:, 3], match
        v_lo = torch.where(c_hit, c_vlo, final[:, 2])
        v_hi = torch.where(c_hit, c_vhi, final[:, 3])
        return v_lo, v_hi, match | c_hit, c_hit

    if st.meter is None:
        return spmd_get, (cap_m, cap_d)

    # Transport seam: meter each batched Get with the same per-op protocol
    # costs the scalar paths account, so the mesh workload replays on the
    # simulated RDMA clock.  Pure observation — results pass through.
    def metered_get(q_lo, q_hi, *arrays):
        out = spmd_get(q_lo, q_hi, *arrays)
        n = int(q_lo.numel())
        if cache is not None:
            n_hit = int(out[3].sum())
            meter_cache_batch(st.meter, n_hit, 0)
            n -= n_hit
        if variant == "race":
            st.meter.add(n, rts=2, req=32,
                         resp=2 * RaceKVS.GROUP_BYTES + KV_BLOCK_BYTES,
                         one_sided=True, cn_hash=3,
                         cn_cmp=2 * RaceKVS.GROUP_SLOTS + 1)
        else:
            st.meter.add(n, rts=1, req=GET_REQ_BYTES, resp=KV_BLOCK_BYTES,
                         cn_hash=5, cn_cmp=1, mn_reads=2)
        return out

    return metered_get, (cap_m, cap_d)


def _block(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host block as a tensor of its own on ``device`` (uint32 as int32
    bit patterns)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device, copy=True)


def place_state(mesh: RankMesh, st: ShardedKVSState):
    """This rank's blocks of the stacked arrays, on ``mesh.device``, in the
    order of ``st.arrays()``: the CN arrays of shard ``m`` (``P("model")``)
    and bucket rows and heap rows ``d`` of shard ``m`` (``P("model",
    "data")``)."""
    D, M = mesh.shape["data"], mesh.shape["model"]
    if st.words_a.shape[0] != M:
        raise ValueError(f"state has {st.words_a.shape[0]} shards, the mesh's "
                         f"model axis {M}")
    if st.num_buckets % D or st.heap_cap % D:
        raise ValueError(f"state rows do not split over data={D}")
    d, m = mesh.coords
    nb, hc = st.num_buckets // D, st.heap_cap // D
    cn = [a[m] for a in st.arrays()[:4]]
    mn = [a[m, d * nb:(d + 1) * nb] for a in (st.slots_lo, st.slots_hi)]
    mn += [a[m, d * hc:(d + 1) * hc] for a in st.arrays()[6:]]
    return tuple(_block(a, mesh.device) for a in cn + mn)


def place_cache(mesh: RankMesh, cache: ShardedCNCache):
    """This rank's CN-cache replica (``P(("data", "model"))``: one replica
    per rank), copied onto ``mesh.device``."""
    ndev = mesh.size
    if cache.ndev != ndev:
        raise ValueError(f"cache built for {cache.ndev} devices, "
                         f"mesh has {ndev}")
    return tuple(a.to(mesh.device, copy=True) for a in cache.cache.arrays())
