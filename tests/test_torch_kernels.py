"""Port kernels' plain versions and wrappers vs the reference's Pallas kernels.

On the CPU the wrappers in ``repro_torch.kernels.ops`` take the plain
PyTorch versions; both are held bit for bit against ``repro``'s Pallas
kernels run in interpret mode (through ``repro.kernels.ops`` with
``mode="pallas"``, which pads to the kernel block the way the reference
does) and against the reference's host ``LudoCN.locate``.  Ragged batch
sizes 1, 1023 and 1025 are covered; the CUDA kernels are checked against
the same plain versions on the card by ``test_kernels_on_card`` and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.hashing import split_u64, splitmix64
from repro.core.outback import OutbackShard
from repro.core.store import make_uniform_keys
from repro.kernels import ops as r_ops
from repro_torch.core import outback as t_outback
from repro_torch.core.hashing import lanes, to_u32_numpy
from repro_torch.kernels import ops, ref

BATCHES = [1, 1023, 1025, 4096]


@pytest.fixture(scope="module")
def shards():
    keys = make_uniform_keys(40_000)
    vals = splitmix64(keys)
    r = OutbackShard(keys, vals, load_factor=0.9)
    t = t_outback.OutbackShard(keys, vals, load_factor=0.9, device="cpu")
    return r, t, keys


def _cn_tensors(r):
    oth = r.cn.othello
    return (lanes(oth.words_a, "cpu"), lanes(oth.words_b, "cpu"),
            torch.from_numpy(r.cn.seeds.copy()))


def test_cn_meta_matches_reference(shards):
    r, t, _ = shards
    assert ops.cn_meta_from(t) == r_ops.cn_meta_from(r)


@pytest.mark.parametrize("batch", BATCHES)
def test_ludo_lookup_vs_pallas_and_locate(shards, batch):
    r, t, keys = shards
    ops.reset_launch_counts()
    meta = r_ops.cn_meta_from(r)
    lo, hi = split_u64(keys[:batch])
    oth = r.cn.othello
    rb, rs = r_ops.ludo_lookup(lo, hi, oth.words_a, oth.words_b, r.cn.seeds,
                               meta, mode="pallas")
    wa, wb, seeds = _cn_tensors(r)
    tlo, thi = lanes(lo, "cpu"), lanes(hi, "cpu")
    pb, ps = ref.ludo_lookup_ref(tlo, thi, wa, wb, seeds, **meta)
    ob, os_ = ops.ludo_lookup(tlo, thi, wa, wb, seeds, meta)
    # and the port shard's own CN arrays, through its LudoCN
    lb, ls = t.cn.locate(tlo, thi)
    hb, hs = r.cn.locate(lo, hi)
    for b, s in ((pb, ps), (ob, os_), (lb, ls)):
        assert b.dtype == s.dtype == torch.int32 and b.shape == (batch,)
        np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(b.numpy(), hb.astype(np.int32))
        np.testing.assert_array_equal(s.numpy(), hs.astype(np.int32))
    assert ops.LAUNCHES == {"ludo_lookup": 0, "slot_unpack": 0}


@pytest.mark.parametrize("batch", BATCHES)
def test_slot_unpack_vs_pallas(batch):
    rng = np.random.default_rng(batch)
    s_lo = rng.integers(0, 2**32, batch, dtype=np.uint64).astype(np.uint32)
    s_hi = rng.integers(0, 2**32, batch, dtype=np.uint64).astype(np.uint32)
    s_lo[0] = s_hi[0] = 0xFFFFFFFF  # all bits set
    s_lo[-1] = s_hi[-1] = 0
    ops.reset_launch_counts()
    want = r_ops.slot_unpack(s_lo, s_hi, mode="pallas")
    for got in (ref.slot_unpack_ref(lanes(s_lo, "cpu"), lanes(s_hi, "cpu")),
                ops.slot_unpack(lanes(s_lo, "cpu"), lanes(s_hi, "cpu"))):
        assert all(g.dtype == torch.int32 for g in got)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(to_u32_numpy(got[3]), np.asarray(want[3]))
    assert ops.LAUNCHES == {"ludo_lookup": 0, "slot_unpack": 0}


def test_wrappers_reject_what_the_kernels_do_not_take(shards):
    r, _, keys = shards
    meta = r_ops.cn_meta_from(r)
    wa, wb, seeds = _cn_tensors(r)
    lo = lanes(split_u64(keys[:64])[0], "cpu")
    with pytest.raises(TypeError):
        ops.ludo_lookup(lo.long(), lo, wa, wb, seeds, meta)
    with pytest.raises(TypeError):
        ops.ludo_lookup(lo, lo, wa, wb, seeds.int(), meta)
    with pytest.raises(ValueError):
        ops.ludo_lookup(lo, lo[:10], wa, wb, seeds, meta)
    with pytest.raises(ValueError):
        ops.ludo_lookup(lo[::2], lo[::2], wa, wb, seeds, meta)
    with pytest.raises(ValueError):
        ops.ludo_lookup(lo, lo, wa[:4], wb, seeds, meta)
    with pytest.raises(ValueError):
        ops.ludo_lookup(lo, lo, wa, wb, seeds[:10], meta)
    with pytest.raises(ValueError):
        ops.slot_unpack(lo.view(8, 8), lo.view(8, 8))
    with pytest.raises(ValueError):
        ops.slot_unpack(lo, lo[:3])
    with pytest.raises(ValueError):
        ops.slot_unpack(lo.to("meta"), lo.to("meta"))


def test_empty_batches(shards):
    r, _, _ = shards
    wa, wb, seeds = _cn_tensors(r)
    e = torch.empty(0, dtype=torch.int32)
    b, s = ops.ludo_lookup(e, e, wa, wb, seeds, r_ops.cn_meta_from(r))
    assert b.shape == s.shape == (0,)
    assert all(o.shape == (0,) for o in ops.slot_unpack(e, e))


@pytest.mark.cuda
def test_kernels_on_card(shards):
    """The CUDA kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    r, _, keys = shards
    meta = r_ops.cn_meta_from(r)
    wa, wb, seeds = (x.cuda() for x in _cn_tensors(r))
    for batch in BATCHES:
        lo, hi = (lanes(x, "cuda") for x in split_u64(keys[:batch]))
        got = ops.ludo_lookup(lo, hi, wa, wb, seeds, meta)
        want = ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got = ops.slot_unpack(lo, hi)
        want = ref.slot_unpack_ref(lo, hi)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
