"""Port kernels' plain versions and wrappers vs the reference's Pallas kernels.

The fused RMSNorm -> matmul plain version and its CPU wrapper are held
against ``repro``'s ``fused_norm_matmul_kernel`` in interpret mode at the
shapes of ``tests/test_kernels.py`` plus ragged S and F, with that file's
tolerances (1e-4 in float32, 3e-2 in bf16).

The paged-attention plain version and its CPU wrappers are held against
``repro``'s ``paged_attention_kernel`` and ``cuckoo_paged_attention_kernel``
in interpret mode at the shapes of ``tests/test_kernels.py`` (ragged
``seq_len`` and bf16 included), to 1e-5 relative and absolute: both sides
compute in float32 from identical values (bf16 inputs are made in float32
with numpy and rounded to nearest even by both frameworks), and only the
order of the sums differs.

On the CPU the wrappers in ``repro_torch.kernels.ops`` take the plain
PyTorch versions; both are held bit for bit against ``repro``'s Pallas
kernels run in interpret mode (through ``repro.kernels.ops`` with
``mode="pallas"``, which pads to the kernel block the way the reference
does) and against the reference's host ``LudoCN.locate``.  Ragged batch
sizes 1, 1023 and 1025 are covered; the CUDA kernels are checked against
the same plain versions on the card by ``tests/test_torch_cuda.py`` (which
imports neither jax nor ``repro``, so it runs on the GPU machine) and by
``chip_smoke.py``.

The paged wrappers take the plain version on the CPU at every head width
the reference computes: d = 16 (the reduced configs' width) and d = 32
are held against ``repro``'s reference and Pallas kernels here, while the
CUDA kernels' own limits (``ops._check_paged_cuda``: widths 64 and 128,
shared memory, grid, 16-byte starts) apply to CUDA tensors only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import split_u64, splitmix64
from repro.core.outback import OutbackShard
from repro.core.store import make_uniform_keys
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.fused_norm_matmul import fused_norm_matmul_kernel
from repro.kernels.paged_attention import (cuckoo_paged_attention_kernel,
                                           paged_attention_kernel)
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
    assert not any(ops.LAUNCHES.values())


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
    assert not any(ops.LAUNCHES.values())


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


# --------------------------------------------------------- paged attention
PAGED_SHAPES = [  # n_kv, g, d, ps, L, seq_len, dtype (tests/test_kernels.py)
    (2, 4, 64, 16, 4, 64, "float32"),
    (2, 4, 64, 16, 4, 49, "float32"),  # ragged last page
    (4, 2, 128, 32, 8, 250, "float32"),
    (1, 8, 64, 16, 2, 32, "bfloat16"),
]
TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_inputs(seed, n_kv, g, d, ps, L, dtype, pool=None, starts=None):
    """The same inputs for both packages: numpy float32, rounded to bf16 by
    each framework where asked.  The cuckoo map's first step is the
    unselected candidate, and with ``starts`` the first step of every run
    of ``starts`` pages."""
    rng = np.random.default_rng(seed)
    pool = 3 * L if pool is None else pool
    q = rng.standard_normal((n_kv, g, d)).astype(np.float32)
    k = rng.standard_normal((pool, ps, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((pool, ps, n_kv, d)).astype(np.float32)
    pm = rng.choice(pool, L, replace=False).astype(np.int32)
    decoy = rng.choice(pool, L, replace=False).astype(np.int32)
    sel = rng.integers(0, 2, L).astype(np.int32)
    sel[0] = 1  # step 0 is the unselected candidate
    if starts:
        sel[::starts] = 1
    pm2 = np.where(sel[:, None] == 0, np.stack([pm, decoy], 1),
                   np.stack([decoy, pm], 1)).astype(np.int32)
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tx = tuple(torch.from_numpy(a).to(getattr(torch, dtype))
               for a in (q, k, v))
    return jx, tx, pm, pm2, sel


def _close(got, want):
    for g_, w in zip(got, want):
        assert g_.dtype == torch.float32
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), **TOL)


def test_bf16_inputs_round_alike():
    (jq, jk, _), (tq, tk, _), *_ = _paged_inputs(0, 1, 8, 64, 16, 2,
                                                 "bfloat16")
    for j, t in ((jq, tq), (jk, tk)):
        np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)),
                                      t.float().numpy())


@pytest.mark.parametrize("n_kv,g,d,ps,L,seq_len,dtype", PAGED_SHAPES)
def test_paged_attention_vs_pallas(n_kv, g, d, ps, L, seq_len, dtype):
    (jq, jk, jv), (tq, tk, tv), pm, _, _ = _paged_inputs(1, n_kv, g, d, ps,
                                                         L, dtype)
    ops.reset_launch_counts()
    want = paged_attention_kernel(jq, jk, jv, jnp.asarray(pm),
                                  jnp.asarray([seq_len], jnp.int32),
                                  interpret=True)
    tpm = torch.from_numpy(pm)
    _close(ref.paged_attention_ref(tq, tk, tv, tpm, seq_len), want)
    _close(ops.paged_attention(tq, tk, tv, tpm, seq_len), want)
    _close(ref.paged_attention_ref(tq, tk, tv, tpm, seq_len),
           r_ref.paged_attention_ref(jq, jk, jv, jnp.asarray(pm),
                                     jnp.int32(seq_len)))
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("n_kv,g,d,ps,L,seq_len,dtype", PAGED_SHAPES)
def test_cuckoo_paged_attention_vs_pallas(n_kv, g, d, ps, L, seq_len, dtype):
    """Both candidates of every page stream in; step 0 is the unselected
    one, so the finite sentinel's wash-out is exercised."""
    (jq, jk, jv), (tq, tk, tv), _, pm2, sel = _paged_inputs(
        2, n_kv, g, d, ps, L, dtype)
    ops.reset_launch_counts()
    want = cuckoo_paged_attention_kernel(
        jq, jk, jv, jnp.asarray(pm2), jnp.asarray(sel),
        jnp.asarray([seq_len], jnp.int32), interpret=True)
    got = ops.cuckoo_paged_attention(tq, tk, tv, torch.from_numpy(pm2),
                                     torch.from_numpy(sel), seq_len)
    _close(got, want)
    # and the same as the Ludo kernel over the selected pages
    true_pm = pm2[np.arange(L), sel]
    _close(got, paged_attention_kernel(jq, jk, jv, jnp.asarray(true_pm),
                                       jnp.asarray([seq_len], jnp.int32),
                                       interpret=True))
    assert not any(ops.LAUNCHES.values())


def test_flash_combine_vs_reference():
    """Partials over two page ranges combine to full attention, as in the
    reference."""
    n_kv, g, d, ps, L, seq = 2, 4, 64, 16, 8, 128
    (jq, jk, jv), (tq, tk, tv), pm, _, _ = _paged_inputs(3, n_kv, g, d, ps,
                                                         L, "float32")
    tpm, jpm = torch.from_numpy(pm), jnp.asarray(pm)
    t_parts = [ops.paged_attention(tq, tk, tv, tpm[sl].contiguous(), 64)
               for sl in (slice(0, 4), slice(4, 8))]
    j_parts = [r_ref.paged_attention_ref(jq, jk, jv, jpm[sl], jnp.int32(64))
               for sl in (slice(0, 4), slice(4, 8))]
    got = ops.flash_combine(*zip(*t_parts))
    want = r_ref.combine_flash_partials(*(list(x) for x in zip(*j_parts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = ref.paged_attention_ref(tq, tk, tv, tpm, seq)[0]
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


def test_paged_wrappers_reject_what_the_kernels_do_not_take():
    _, (q, k, v), pm, pm2, sel = _paged_inputs(4, 2, 4, 64, 16, 4, "float32")
    pm, pm2, sel = (torch.from_numpy(a) for a in (pm, pm2, sel))
    with pytest.raises(TypeError):
        ops.paged_attention(q.double(), k.double(), v.double(), pm, 64)
    with pytest.raises(TypeError):
        ops.paged_attention(q, k.bfloat16(), v, pm, 64)
    with pytest.raises(TypeError):
        ops.paged_attention(q, k, v, pm.long(), 64)
    with pytest.raises(ValueError):
        ops.paged_attention(q, k[:, :, :1].contiguous(), v, pm, 64)
    with pytest.raises(ValueError):
        ops.paged_attention(q, k, v, pm[::2], 64)
    with pytest.raises(ValueError):
        ops.paged_attention(q, k, v, pm[:0], 64)
    with pytest.raises(ValueError):
        ops.paged_attention(q, k, v, pm, 0)
    with pytest.raises(ValueError):
        ops.cuckoo_paged_attention(q, k, v, pm2, sel[:3], 64)
    with pytest.raises(ValueError):
        ops.cuckoo_paged_attention(q, k, v, pm2.t(), sel, 64)
    with pytest.raises(ValueError):
        ops.paged_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                            pm.to("meta"), 64)


# Head widths below the CUDA kernels' 64 and 128, which the reference
# computes and a CPU tensor must get (the reduced configs have d = 16).
PAGED_SMALL_D_SHAPES = [  # n_kv, g, d, ps, L, seq_len, dtype
    (2, 4, 16, 16, 4, 50, "float32"),
    (2, 4, 16, 16, 4, 50, "bfloat16"),
    (1, 8, 32, 16, 2, 20, "float32"),
    (1, 8, 32, 16, 2, 20, "bfloat16"),
]


@pytest.mark.parametrize("n_kv,g,d,ps,L,seq_len,dtype", PAGED_SMALL_D_SHAPES)
def test_paged_attention_small_heads_on_cpu(n_kv, g, d, ps, L, seq_len,
                                            dtype):
    (jq, jk, jv), (tq, tk, tv), pm, _, _ = _paged_inputs(6, n_kv, g, d, ps,
                                                         L, dtype)
    ops.reset_launch_counts()
    tpm = torch.from_numpy(pm)
    got = ops.paged_attention(tq, tk, tv, tpm, seq_len)
    assert tuple(got[0].shape) == (n_kv, g, d)
    _close(got, paged_attention_kernel(jq, jk, jv, jnp.asarray(pm),
                                       jnp.asarray([seq_len], jnp.int32),
                                       interpret=True))
    _close(got, r_ref.paged_attention_ref(jq, jk, jv, jnp.asarray(pm),
                                          jnp.int32(seq_len)))
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("n_kv,g,d,ps,L,seq_len,dtype", PAGED_SMALL_D_SHAPES)
def test_cuckoo_paged_attention_small_heads_on_cpu(n_kv, g, d, ps, L,
                                                   seq_len, dtype):
    (jq, jk, jv), (tq, tk, tv), _, pm2, sel = _paged_inputs(
        7, n_kv, g, d, ps, L, dtype)
    ops.reset_launch_counts()
    got = ops.cuckoo_paged_attention(tq, tk, tv, torch.from_numpy(pm2),
                                     torch.from_numpy(sel), seq_len)
    _close(got, cuckoo_paged_attention_kernel(
        jq, jk, jv, jnp.asarray(pm2), jnp.asarray(sel),
        jnp.asarray([seq_len], jnp.int32), interpret=True))
    true_pm = jnp.asarray(pm2[np.arange(L), sel])
    _close(got, r_ref.paged_attention_ref(jq, jk, jv, true_pm,
                                          jnp.int32(seq_len)))
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("d", [16, 32])
def test_cuda_paged_check_refuses_unbuilt_head_widths(d):
    """The CUDA kernels are built for d = 64 and 128 only; the check that
    only their branch runs refuses the rest (on CUDA tensors the wrappers
    raise it: tests/test_torch_cuda.py)."""
    _, (q, k, v), pm, _, _ = _paged_inputs(8, 2, 4, d, 16, 4, "float32")
    sz = ops._check_paged(q, k, v, len(pm), 64)
    with pytest.raises(ValueError, match="head width"):
        ops._check_paged_cuda(sz, k, v)
    wide = _paged_inputs(8, 2, 4, 64, 16, 4, "float32")[1]
    ops._check_paged_cuda(ops._check_paged(*wide, len(pm), 64), *wide[1:])


# -------------------------------------------------------- fused norm matmul
# (S, d, F, dtype, block_s, block_f): the shapes of tests/test_kernels.py,
# then ragged S and F (the Pallas kernel takes them as whole blocks)
FNM_SHAPES = [
    (256, 512, 1024, "float32", 128, 256),
    (512, 256, 512, "float32", 256, 512),
    (128, 1024, 512, "bfloat16", 128, 128),
    (7, 200, 100, "float32", 7, 100),
    (9, 64, 131, "bfloat16", 9, 131),
    # qwen3-4b's width (d = 2560) at a prefill of S = 256, its k / v F
    (256, 2560, 1024, "bfloat16", 128, 512),
]
FNM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # tests/test_kernels.py:138


def _fnm_inputs(seed, S, d, F, dtype):
    """tests/test_kernels.py's inputs: numpy float32, rounded to bf16 by
    each framework where asked."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((S, d)), rng.standard_normal((d,)),
            rng.standard_normal((d, F)) / np.sqrt(d))
    arrs = tuple(a.astype(np.float32) for a in arrs)
    return (tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs),
            tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs))


@pytest.mark.parametrize("S,d,F,dtype,bs,bf", FNM_SHAPES)
def test_fused_norm_matmul_vs_pallas(S, d, F, dtype, bs, bf):
    (jx, jg, jw), (tx, tg, tw) = _fnm_inputs(4, S, d, F, dtype)
    ops.reset_launch_counts()
    want = np.asarray(fused_norm_matmul_kernel(jx, jg, jw, block_s=bs,
                                               block_f=bf, interpret=True),
                      np.float32)
    tol = FNM_TOL[dtype]
    for got in (ref.fused_norm_matmul_ref(tx, tg, tw),
                ops.fused_norm_matmul(tx, tg, tw)):
        assert got.dtype == getattr(torch, dtype) and got.shape == (S, F)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
    np.testing.assert_allclose(
        ref.fused_norm_matmul_ref(tx, tg, tw).float().numpy(),
        np.asarray(r_ref.fused_norm_matmul_ref(jx, jg, jw), np.float32),
        rtol=tol, atol=tol)
    assert not any(ops.LAUNCHES.values())


def test_fused_norm_matmul_wrapper_rejects_what_the_kernel_does_not_take():
    _, (x, g, w) = _fnm_inputs(5, 8, 64, 96, "float32")
    with pytest.raises(TypeError):  # mixed dtypes
        ops.fused_norm_matmul(x, g.bfloat16(), w)
    with pytest.raises(TypeError):
        ops.fused_norm_matmul(x, g, w.bfloat16())
    with pytest.raises(TypeError):  # a type the kernel is not built for
        ops.fused_norm_matmul(x.double(), g.double(), w.double())
    with pytest.raises(ValueError):  # wrong ranks
        ops.fused_norm_matmul(x[None], g, w)
    with pytest.raises(ValueError):
        ops.fused_norm_matmul(x, g[None], w)
    with pytest.raises(ValueError):  # non-contiguous w
        ops.fused_norm_matmul(x, g, w.t().contiguous().t())
    with pytest.raises(ValueError):  # mismatched d
        ops.fused_norm_matmul(x, g, w[:32].contiguous())
    with pytest.raises(ValueError):
        ops.fused_norm_matmul(x, g[:32].contiguous(), w)
    with pytest.raises(ValueError):  # one device
        ops.fused_norm_matmul(x, g, w.to("meta"))
    # meta (the dry run's device) takes the shapes and launches nothing
    before = dict(ops.LAUNCHES)
    y = ops.fused_norm_matmul(x.to("meta"), g.to("meta"), w.to("meta"))
    assert (y.is_meta, tuple(y.shape), y.dtype) == (True, (8, 96),
                                                     torch.float32)
    assert ops.LAUNCHES == before
    assert ops.fused_norm_matmul(x[:0], g, w).shape == (0, 96)
