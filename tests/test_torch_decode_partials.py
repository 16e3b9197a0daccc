"""The decode over a split sequence in isolation: ``attention.decode_partials``
of each range of a cache, combined with ``ops.flash_combine`` in order,
against ``attention.decode_attention`` over the whole cache (float32,
1e-6), for the masks the decode runs (full, a sliding ``window``, a
rolling cache's valid count) and splits into 1-4 ranges, ranges with no
live position included; and ``SeqSplit``'s packing of its one
``all_gather`` over a stand-in mesh of ranks.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as att

TOL = 1e-6
B, S, D = 2, 24, 16


def _inputs(H: int, Hkv: int, seed: int):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D))
                         .astype(np.float32))
    return q, k, v


def _split_decode(q, k, v, length, n: int, *, window=None, heads=None):
    """``n`` ranges of the cache, each's partials, combined in order."""
    s_loc = S // n
    parts = [att.decode_partials(q, k[:, r * s_loc:(r + 1) * s_loc],
                                 v[:, r * s_loc:(r + 1) * s_loc], length,
                                 window=window, heads=heads, pos0=r * s_loc)
             for r in range(n)]
    return parts, ops.flash_combine(*zip(*parts))


# (length of each row, window): row 0's early length leaves every range
# but the first without a live position; the window leaves the first
# ranges of row 1 without one
MASKS = {"full": ([3, 20], None), "window": ([9, 20], 5),
         "rolling": ([S, 7], None)}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("H,Hkv,heads", [(4, 2, None), (4, 4, None),
                                         (5, 2, [0, 0, 1, 1, 1])])
def test_partials_combined_equal_the_whole_decode(n, mask, H, Hkv, heads):
    """The combine of the ranges' partials equals ``decode_attention`` over
    the whole cache; the plain GQA pattern reads each kv head once for its
    group, other maps go through ``kv_idx``'s index select."""
    lengths, window = MASKS[mask]
    q, k, v = _inputs(H, Hkv, seed=n + 10 * H)
    length = torch.tensor(lengths)
    if mask == "rolling":  # the valid count of a rolling cache of S slots
        length = torch.clamp(length, max=S)
    kv_idx = None if heads is None else torch.tensor(heads)
    want = att.decode_attention(q, k, v, length, window=window,
                                kv_idx=kv_idx).reshape(B, H, D)
    parts, got = _split_decode(q, k, v, length, n, window=window,
                               heads=heads)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    for o, m, l in parts:
        assert o.dtype == m.dtype == l.dtype == torch.float32
        assert o.shape == (B, H, D) and m.shape == l.shape == (B, H)


def test_a_range_with_no_live_position_weighs_zero():
    """A range past the length has m = NEG_INF and finite (o, l); its
    weight in the combine, exp(NEG_INF - m_max), is 0, so dropping it
    changes nothing."""
    q, k, v = _inputs(4, 2, seed=3)
    length = torch.tensor([5, 5])
    parts, got = _split_decode(q, k, v, length, 4)
    for o, m, l in parts[1:]:
        assert torch.all(m == att.NEG_INF)
        assert torch.isfinite(o).all() and torch.all(l == S // 4)
    alone = ops.flash_combine(*zip(parts[0]))
    torch.testing.assert_close(got, alone, rtol=0, atol=0)
    torch.testing.assert_close(got, parts[0][0], rtol=TOL, atol=TOL)


class _Ranks:
    """A stand-in for ``launch.mesh.Mesh`` over one axis of ``n`` ranks,
    whose ``all_gather`` returns the tensors each rank put in last (the
    caller's own where a rank has put none yet): the last rank to call
    gets every rank's."""

    def __init__(self, n: int):
        self.n, self.rank, self.put = n, 0, {}

    def axis_index(self, axes) -> int:
        return self.rank

    def axis_size(self, axes) -> int:
        return self.n

    def all_gather(self, x, axes, dim: int = 0):
        self.put[self.rank] = x
        return torch.cat([self.put.get(r, x) for r in range(self.n)],
                         dim=dim)


def test_seq_split_packs_one_gather():
    """``SeqSplit.combine`` gathers (o, m, l) packed in one tensor and
    combines in rank order; ``gather_heads`` packs tensors of other
    head counts and widths into one gather and gives each back with every
    rank's heads in rank order."""
    q, k, v = _inputs(4, 2, seed=4)
    length = torch.tensor([11, 17])
    mesh = _Ranks(2)
    split = att.SeqSplit(mesh, ("data",))
    parts, want = _split_decode(q, k, v, length, 2)
    for r in (1, 0):  # rank 1 puts its partials in first
        mesh.rank = r
        got = split.combine(*parts[r])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert split.pos0(12) == 0 and split.size() == 2
    mesh.put.clear()
    rng = np.random.default_rng(5)
    xs = {r: (torch.from_numpy(rng.standard_normal((B, 1, 3, 8))
                               .astype(np.float32)),
              torch.from_numpy(rng.standard_normal((B, 1, 2, 5))
                               .astype(np.float32))) for r in (0, 1)}
    for r in (0, 1):
        mesh.rank = r
        a, b = att.gather_heads(split.mesh, *xs[r])
    torch.testing.assert_close(a, torch.cat([xs[0][0], xs[1][0]], dim=2),
                               rtol=0, atol=0)
    torch.testing.assert_close(b, torch.cat([xs[0][1], xs[1][1]], dim=2),
                               rtol=0, atol=0)
