"""Vectorised DMPH maintenance: the write half of the Ludo build path.

The port of ``repro.core.maintenance``, on torch tensors and bit-identical
to it for the same keys and ``rng_seed``:

* :func:`one_shot_seeds` — lowest-valid 8-bit seed per bucket, searched
  over ``(buckets, seed tile, 4)`` at once;
* :func:`cuckoo_place` — (2,4)-cuckoo placement: greedy waves, then a
  batched frontier eviction walk driven by a ``numpy.random.Generator``
  seeded ``rng_seed ^ 0x5EED`` and drawn in the reference's order, so the
  random stream (and hence the placement) is the reference's;
* :func:`find_bucket_seeds_batch` — the insert-time re-seed (§4.3.2 case 2);
* :func:`gather_buckets` — each bucket's (<=4) keys as dense lanes.

The reference's scalar ``*_reference`` twins are its own oracles and are
not ported: the port is held against ``repro`` itself.  The build runs on
the host, as in the paper; nothing here depends on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import popcount32, slot_hash
from repro_torch.core.othello import first_of_each

MAX_SEED = 256  # 8-bit per-bucket seeds, as in the paper
SEED_TILE = 32  # seeds searched per array op round (8 tiles cover MAX_SEED)
EVICT_MAX_ROUNDS = 800  # frontier rounds

# Empty bucket lanes hash to sentinel slots 4..7, disjoint from the real
# slots 0..3, so a bucket with k < 4 keys still tests "popcount == 4".
_SENTINEL = 4 + torch.arange(4, dtype=torch.int64)
# Buckets searched per array op: bounds the (chunk, tile, 4) temporaries.
_CHUNK = 1 << 18


# ---------------------------------------------------------------------------
# seed search


def one_shot_seeds(g_lo, g_hi, valid, *, max_seed: int = MAX_SEED,
                   tile: int | None = None):
    """Vectorised lowest-valid-seed search over gathered buckets.

    ``g_lo``/``g_hi`` are ``(nb, 4)`` lanes per bucket (empty lanes
    arbitrary), ``valid`` the matching bool mask.  Returns ``(seeds uint8,
    ok bool)``; ``ok[b]`` is False when no seed in ``[0, max_seed)`` maps
    bucket ``b``'s keys to distinct slots.  Tiles scan seeds in ascending
    order, so the lowest valid seed wins, as in the reference.
    """
    nb = int(g_lo.shape[0])
    device = g_lo.device
    seeds = torch.zeros(nb, dtype=torch.uint8, device=device)
    ok = ~valid.any(dim=1)  # empty buckets resolve to seed 0 immediately
    if tile is None:
        # tiny batches (single-bucket re-seeds) are cheaper in one shot
        tile = max_seed if nb <= 64 else SEED_TILE
    todo = torch.nonzero(~ok).flatten()
    sentinel = _SENTINEL.to(device)[None, None, :]
    for s0 in range(0, max_seed, tile):
        if todo.numel() == 0:
            break
        svals = torch.arange(s0, min(s0 + tile, max_seed), dtype=torch.int64,
                             device=device)
        lanes = torch.arange(svals.numel(), device=device)
        hit = torch.zeros(todo.numel(), dtype=torch.bool, device=device)
        for c0 in range(0, todo.numel(), _CHUNK):
            t = todo[c0:c0 + _CHUNK]
            # (t, S, 4): every remaining bucket x every seed of the tile
            h = slot_hash(g_lo[t][:, None, :], g_hi[t][:, None, :],
                          svals[None, :, None])
            h = torch.where(valid[t][:, None, :], h, sentinel)
            m = 1 << h
            bits = m[..., 0] | m[..., 1] | m[..., 2] | m[..., 3]
            good = popcount32(bits) == 4
            hit_c = good.any(dim=1)
            # lowest good seed of each bucket (first True along the tile)
            first = torch.where(good, lanes, svals.numel()).min(dim=1).values
            found = t[hit_c]
            seeds[found] = (s0 + first[hit_c]).to(torch.uint8)
            ok[found] = True
            hit[c0:c0 + _CHUNK] = hit_c
        todo = todo[~hit]
    return seeds, ok


def find_bucket_seeds_batch(k_lo, k_hi, counts) -> torch.Tensor:
    """Insert-time re-seed over a batch of buckets (§4.3.2 case 2).

    ``k_lo``/``k_hi`` are ``(B, 4)`` lanes (lane ``j`` meaningful when
    ``j < counts[b]``).  Returns int16 seeds, ``-1`` where no 8-bit seed is
    perfect (the caller falls back to the overflow cache)."""
    counts = torch.as_tensor(counts, dtype=torch.int64, device=k_lo.device)
    valid = torch.arange(4, device=k_lo.device)[None, :] < counts[:, None]
    seeds, ok = one_shot_seeds(k_lo, k_hi, valid)
    out = seeds.to(torch.int16)
    out[~ok] = -1
    return out


def gather_buckets(lo, hi, bucket_of, num_buckets: int):
    """Gather each bucket's (<=4) keys into dense ``(nb, 4)`` lanes.

    Returns ``(g_lo, g_hi, valid, order, bsorted)``: ``order`` is the placed
    keys sorted by bucket and ``bsorted`` their buckets.  Raises
    ``ValueError`` if any bucket holds more than 4 keys."""
    device = lo.device
    placed = torch.nonzero(bucket_of >= 0).flatten()
    order = placed[torch.sort(bucket_of[placed], stable=True).indices]
    bsorted = bucket_of[order]
    ids = torch.arange(num_buckets, device=device)
    start = torch.searchsorted(bsorted, ids)
    end = torch.searchsorted(bsorted, ids, right=True)
    if num_buckets and int((end - start).max()) > 4:
        raise ValueError("bucket occupancy > 4 after placement")
    lane = torch.arange(order.numel(), device=device) - start[bsorted]
    key_at = torch.full((num_buckets, 4), -1, dtype=torch.int64, device=device)
    key_at[bsorted, lane] = order
    valid = key_at >= 0
    safe = key_at.clamp(min=0)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    g_lo = torch.where(valid, lo.to(torch.int64)[safe], zero)
    g_hi = torch.where(valid, hi.to(torch.int64)[safe], zero)
    return g_lo, g_hi, valid, order, bsorted


# ---------------------------------------------------------------------------
# cuckoo placement


def _greedy_pass(idx, cand, occ, fill, bucket_of):
    """Place keys ``idx`` into buckets ``cand`` up to capacity (in order).

    Ranks keys within equal-bucket runs so each bucket accepts at most its
    remaining capacity this pass.  Returns what it could not place."""
    order = torch.sort(cand, stable=True).indices
    idx, cand = idx[order], cand[order]
    new_run = torch.ones_like(cand, dtype=torch.bool)
    new_run[1:] = cand[1:] != cand[:-1]
    start = torch.nonzero(new_run).flatten()
    run_id = torch.cumsum(new_run.to(torch.int64), 0) - 1
    rank = torch.arange(cand.numel(), device=cand.device) - start[run_id]
    slot_pos = fill[cand] + rank
    take = slot_pos < 4
    occ[cand[take], slot_pos[take]] = idx[take]
    bucket_of[idx[take]] = cand[take]
    fill.index_add_(0, cand[take], torch.ones_like(cand[take]))
    return idx[~take], cand[~take]


def cuckoo_place(b0, b1, num_buckets: int, rng_seed: int, *,
                 max_rounds: int = EVICT_MAX_ROUNDS):
    """(2,4)-cuckoo placement: greedy waves + a batched frontier eviction.

    ``b0``/``b1`` are each key's two candidate buckets (int64 tensors).
    Returns ``(bucket_of int64[n], fallback int64[])``: ``-1`` / listed in
    ``fallback`` for keys that could not be placed.  Every round, pending
    keys first fill free capacity, then the first pending key of each
    still-full bucket evicts a random resident, which re-enters with its
    other bucket.  Deterministic for a fixed ``rng_seed``.
    """
    device = b0.device
    n = int(b0.shape[0])
    occ = torch.full((num_buckets, 4), -1, dtype=torch.int64, device=device)
    fill = torch.zeros(num_buckets, dtype=torch.int64, device=device)
    bucket_of = torch.full((n,), -1, dtype=torch.int64, device=device)

    rest, _ = _greedy_pass(torch.arange(n, device=device), b0, occ, fill,
                           bucket_of)
    rest, _ = _greedy_pass(rest, b1[rest], occ, fill, bucket_of)
    if rest.numel() == 0:
        return bucket_of, rest

    rng = np.random.default_rng(rng_seed ^ 0x5EED)
    cur = rest
    coin = torch.from_numpy(rng.integers(0, 2, size=cur.numel())).to(device)
    b = torch.where(coin == 0, b0[cur], b1[cur])
    for _ in range(max_rounds):
        if cur.numel() == 0:
            break
        # placement wave: free capacity absorbs what it can
        cur, b = _greedy_pass(cur, b, occ, fill, bucket_of)
        if cur.numel() == 0:
            break
        # eviction wave: the first pending key of each (full) bucket kicks
        # a random resident out; the victim re-enters with its other bucket
        _, first_idx = first_of_each(b)
        ev = torch.zeros(cur.numel(), dtype=torch.bool, device=device)
        ev[first_idx] = True
        eb, ec = b[ev], cur[ev]
        lanes = torch.from_numpy(rng.integers(0, 4, size=eb.numel())).to(device)
        victims = occ[eb, lanes]
        occ[eb, lanes] = ec
        bucket_of[ec] = eb
        alt = torch.where(b0[victims] == eb, b1[victims], b0[victims])
        cur = torch.cat([victims, cur[~ev]])
        b = torch.cat([alt, b[~ev]])
    if cur.numel():
        bucket_of[cur] = -1
    return bucket_of, torch.sort(cur).values
