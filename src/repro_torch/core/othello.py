"""Othello: a dynamic Bloomier-filter map, used as Ludo's bucket locator.

Maps each key to a 1-bit value (``0`` => the key lives in candidate bucket
``h_a(k)``, ``1`` => ``h_b(k)``) using two bit arrays ``A`` (ma bits) and
``B`` (mb bits):

    lookup(k) = A[h_A(k)] xor B[h_B(k)]

The build runs on the host, as in ``repro.core.othello`` and the paper: it
peels the key graph (one edge per key between its ``h_A`` and ``h_B``
nodes) in vectorised rounds and assigns bits in reverse peel order, and
gives the same words and seeds as the reference for the same keys.  Two
numpy idioms have no torch twin and are replaced by equivalents:

* the reference keeps, per node, the xor of its incident edge ids and reads
  it only at degree-1 nodes, where it equals the single incident id.  The
  sum of the ids is that id too, so a plain ``index_add_`` stands in for
  ``np.bitwise_xor.at``;
* ``np.unique(..., return_index=True)`` (first occurrence of each value) is
  :func:`first_of_each` over a stable sort.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import bitarray
from repro_torch.core.hashing import hash_range

_SEED_A0 = 0x0511AD01
_SEED_B0 = 0x0B5EED02


@dataclasses.dataclass
class Othello:
    """Immutable (post-build) Othello map; words are int32 bit patterns."""

    words_a: torch.Tensor
    words_b: torch.Tensor
    ma: int
    mb: int
    seed_a: int
    seed_b: int

    def lookup(self, lo, hi) -> torch.Tensor:
        """Batched 1-bit lookup (int64 0/1)."""
        ia = hash_range(lo, hi, self.seed_a, self.ma)
        ib = hash_range(lo, hi, self.seed_b, self.mb)
        return (bitarray.get_bit(self.words_a, ia)
                ^ bitarray.get_bit(self.words_b, ib))

    def to(self, device) -> "Othello":
        return dataclasses.replace(self, words_a=self.words_a.to(device),
                                   words_b=self.words_b.to(device))

    @property
    def bits(self) -> int:
        return self.ma + self.mb


class OthelloBuildError(RuntimeError):
    pass


def first_of_each(x: torch.Tensor):
    """``np.unique(x, return_index=True)``: the sorted distinct values and
    the index of each one's first occurrence."""
    vals, perm = torch.sort(x, stable=True)
    head = torch.ones_like(vals, dtype=torch.bool)
    head[1:] = vals[1:] != vals[:-1]
    return vals[head], perm[head]


def build(lo, hi, values, *, ma: int | None = None, mb: int | None = None,
          max_attempts: int = 32, seed: int = 0) -> Othello:
    """Construct an Othello over n keys with the given 1-bit values.

    ``lo``/``hi`` are lane tensors (any integer dtype, read as uint32) on
    the host; the words come back on the same device."""
    n = int(lo.shape[0])
    if ma is None:
        ma = max(4, math.ceil(1.33 * n))
    if mb is None:
        mb = max(4, n + 1)
    values = torch.as_tensor(values).to(torch.uint8)
    for attempt in range(max_attempts):
        seed_a = (_SEED_A0 + 0x9E37 * (seed + attempt)) & 0xFFFFFFFF
        seed_b = (_SEED_B0 + 0x85EB * (seed + attempt)) & 0xFFFFFFFF
        bits = _try_build(lo, hi, values, ma, mb, seed_a, seed_b)
        if bits is not None:
            return Othello(bitarray.pack_bits(bits[:ma]),
                           bitarray.pack_bits(bits[ma:]), ma, mb, seed_a,
                           seed_b)
    raise OthelloBuildError(
        f"acyclic Othello not found in {max_attempts} attempts (n={n})")


def _try_build(lo, hi, values, ma, mb, seed_a, seed_b):
    n = int(lo.shape[0])
    m = ma + mb
    device = lo.device
    # edge endpoints: u in [0, ma), v in [ma, ma+mb)
    u = hash_range(lo, hi, seed_a, ma)
    v = hash_range(lo, hi, seed_b, mb) + ma
    deg = torch.bincount(u, minlength=m) + torch.bincount(v, minlength=m)
    eid = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    esum = torch.zeros(m, dtype=torch.int64, device=device)
    esum.index_add_(0, u, eid)
    esum.index_add_(0, v, eid)

    # vectorised peeling: strip all current degree-1 nodes per round
    rounds: list[tuple[torch.Tensor, torch.Tensor]] = []
    removed = torch.zeros(n, dtype=torch.bool, device=device)
    while True:
        ones = torch.nonzero(deg == 1).flatten()
        if ones.numel() == 0:
            break
        # each degree-1 node's single incident edge; both endpoints of an
        # edge may be degree 1, so keep each edge's first node only
        e, first = first_of_each(esum[ones] - 1)
        nodes = ones[first]
        live = ~removed[e]
        e, nodes = e[live], nodes[live]
        if e.numel() == 0:
            break
        removed[e] = True
        rounds.append((e, nodes))
        for end in (u[e], v[e]):
            deg.index_add_(0, end, torch.full_like(end, -1))
            esum.index_add_(0, end, -(e + 1))

    if not bool(removed.all()):
        return None  # cycle: retry with new seeds

    # reverse-round assignment: bit[peel] = bit[other] xor value
    bits = torch.zeros(m, dtype=torch.uint8, device=device)
    for e, nodes in reversed(rounds):
        other = torch.where(u[e] == nodes, v[e], u[e])
        bits[nodes] = bits[other] ^ values[e]
    return bits
