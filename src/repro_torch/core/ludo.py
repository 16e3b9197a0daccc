"""Ludo hashing: the DMPH scheme Outback decouples (paper §2.2, §4.2).

A Ludo table over n keys:
  * ``num_buckets = ceil(n / (4 * load_factor))`` buckets of 4 slots;
  * every key has two candidate buckets ``h_a(k)``, ``h_b(k)``; a (2,4)-cuckoo
    placement assigns each key to one of them;
  * an Othello map stores the 1-bit choice per key (the *bucket locator*);
  * per bucket, an 8-bit seed is brute-forced (<=256 tries) so the seeded
    slot hash maps the bucket's keys to distinct slots.

The build runs on the host (the paper builds and re-seeds on CPUs) and is
array-identical to ``repro.core.ludo.build``; :meth:`LudoCN.to` then moves
the CN half to the device, where :meth:`LudoCN.locate` runs through the
``ludo_lookup`` kernel.

  * ``LudoCN`` (compute node): Othello arrays + seeds.
  * the memory-node half (the slot table) is owned by
    ``repro_torch.core.outback``; the build returns the per-key
    (bucket, slot) assignment the MN table is populated from.
"""

from __future__ import annotations

import dataclasses
import math
import types

import torch

from repro_torch.core import maintenance
from repro_torch.core import othello as othello_mod
from repro_torch.core.hashing import hash_range, slot_hash
from repro_torch.kernels import ops

SEED_BUCKET_A = 0xA11CE
SEED_BUCKET_B = 0xB0BBE
MAX_SEED = maintenance.MAX_SEED  # 8-bit per-bucket seeds, as in the paper


class LudoBuildError(RuntimeError):
    pass


@dataclasses.dataclass
class LudoCN:
    """The compute-heavy / memory-light component cached on compute nodes."""

    othello: othello_mod.Othello
    seeds: torch.Tensor  # uint8[num_buckets]
    num_buckets: int
    # (othello, num_buckets, meta) of the last meta made: see ``meta``.  A
    # class default, not a field: an instance holds it only once a meta was
    # made, so ``vars()`` of a locator image is the reference's
    _meta = None

    @property
    def meta(self) -> types.MappingProxyType:
        """The ``ludo_lookup`` meta of this CN (what ``ops.cn_meta_from``
        returns), made once for each Othello and bucket count: the seeds
        change in place on inserts, the Othello and the bucket count only
        when the CN is rebuilt."""
        cached = self._meta
        if (cached is None or cached[0] is not self.othello
                or cached[1] != self.num_buckets):
            oth = self.othello
            meta = dict(ma=oth.ma, mb=oth.mb, nb=self.num_buckets,
                        seed_a=oth.seed_a, seed_b=oth.seed_b,
                        seed_ba=SEED_BUCKET_A, seed_bb=SEED_BUCKET_B)
            cached = self._meta = (oth, self.num_buckets,
                                   types.MappingProxyType(meta))
        return cached[2]

    def locate(self, lo: torch.Tensor, hi: torch.Tensor):
        """int32 lanes -> (bucket, slot) int32: the paper's entire CN-side
        Get compute, through the ``ludo_lookup`` kernel (its plain version
        when the lanes lie on the CPU)."""
        oth = self.othello
        return ops.ludo_lookup(lo, hi, oth.words_a, oth.words_b, self.seeds,
                               self.meta)

    def to(self, device) -> "LudoCN":
        return LudoCN(self.othello.to(device), self.seeds.to(device),
                      self.num_buckets)

    @property
    def device(self) -> torch.device:
        return self.seeds.device

    @property
    def bits_per_key(self) -> float:
        """The CN's bits (Othello arrays and 8-bit seeds) over the keys its
        buckets hold at load factor 0.95, as the reference counts them."""
        n_keys = max(1, int(round(self.num_buckets * 4 * 0.95)))
        return (self.othello.bits + 8 * self.num_buckets) / n_keys

    def memory_bytes(self) -> int:
        oth = self.othello
        return (oth.words_a.numel() * 4 + oth.words_b.numel() * 4
                + self.seeds.numel())


def candidate_buckets(lo, hi, num_buckets):
    """The two cuckoo candidate buckets of each key (int64)."""
    return (hash_range(lo, hi, SEED_BUCKET_A, num_buckets),
            hash_range(lo, hi, SEED_BUCKET_B, num_buckets))


@dataclasses.dataclass
class LudoBuild:
    cn: LudoCN
    bucket: torch.Tensor  # int64[n]: assigned bucket, uint32 -1 for fallback
    slot: torch.Tensor  # int64[n]: assigned slot
    fallback: torch.Tensor  # int64 indices of keys that could not be placed

    @property
    def ok(self) -> bool:
        return self.fallback.numel() == 0


def build(lo, hi, *, load_factor: float = 0.95, num_buckets: int | None = None,
          oth_ma: int | None = None, oth_mb: int | None = None,
          rng_seed: int = 0) -> LudoBuild:
    """Build a Ludo table over the key lanes ``(lo, hi)`` (host tensors).

    ``num_buckets`` / ``oth_ma`` / ``oth_mb`` force the table geometry."""
    n = int(lo.shape[0])
    if num_buckets is None:
        num_buckets = max(1, math.ceil(n / (4.0 * load_factor)))

    b0, b1 = candidate_buckets(lo, hi, num_buckets)
    bucket_of, fallback = maintenance.cuckoo_place(b0, b1, num_buckets,
                                                   rng_seed)
    choice = ((bucket_of == b1) & (b0 != b1)).to(torch.uint8)
    oth = othello_mod.build(lo, hi, choice, ma=oth_ma, mb=oth_mb,
                            seed=rng_seed)
    seeds, slot_of = _find_seeds(lo, hi, bucket_of, num_buckets)
    cn = LudoCN(oth, seeds, num_buckets)
    return LudoBuild(cn, bucket_of & 0xFFFFFFFF, slot_of, fallback)


def find_bucket_seed(b_lo, b_hi) -> int | None:
    """Lowest 8-bit seed mapping the (<=4) keys to distinct slots, or None.

    The paper's MN-side re-seed step on Insert (case 2, §4.3.2)."""
    k = int(len(b_lo))
    if k == 0:
        return 0
    k_lo = torch.zeros((1, 4), dtype=torch.int64)
    k_hi = torch.zeros((1, 4), dtype=torch.int64)
    k_lo[0, :k] = torch.as_tensor(b_lo, dtype=torch.int64)
    k_hi[0, :k] = torch.as_tensor(b_hi, dtype=torch.int64)
    s = maintenance.find_bucket_seeds_batch(k_lo, k_hi, [k])
    return None if int(s[0]) < 0 else int(s[0])


# ---------------------------------------------------------------------------
# internals


def _find_seeds(lo, hi, bucket_of, num_buckets):
    """Per-bucket 8-bit seed search over the whole table at once."""
    n = int(lo.shape[0])
    device = lo.device
    placed = torch.nonzero(bucket_of >= 0).flatten()
    if placed.numel() == 0:
        return (torch.zeros(num_buckets, dtype=torch.uint8, device=device),
                torch.zeros(n, dtype=torch.int64, device=device))
    try:
        g_lo, g_hi, valid, order, _ = maintenance.gather_buckets(
            lo, hi, bucket_of, num_buckets)
    except ValueError as e:
        raise LudoBuildError(str(e)) from None
    seeds, ok = maintenance.one_shot_seeds(g_lo, g_hi, valid)
    if not bool(ok.all()):
        # the paper observed this never happens with 8-bit seeds; keep the
        # contract explicit rather than silently mis-hashing
        raise LudoBuildError("bucket with no perfect 8-bit seed")
    slot_of = torch.zeros(n, dtype=torch.int64, device=device)
    slot_of[order] = slot_hash(lo[order], hi[order],
                               seeds[bucket_of[order]].to(torch.int64))
    return seeds, slot_of
