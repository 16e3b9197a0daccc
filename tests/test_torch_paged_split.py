"""The paged kernels' split-KV decomposition, on the CPU.

``csrc/paged_attention.cu`` runs a split pass over KV heads x runs of
pages, then a combine pass; ``ops.paged_split_plan`` picks the runs.  The
plan is pinned here, and ``ref.paged_split_partials`` with
``ref.combine_split_partials`` (the decomposition step by step, with the
kernel's finite -1e30 sentinel) is held against ``repro``'s
``paged_attention_ref`` and its Pallas ``paged_attention_kernel`` /
``cuckoo_paged_attention_kernel`` in interpret mode, to 1e-5 relative and
absolute as in ``tests/test_torch_kernels.py``: the same float32 values,
summed in another order.  The cases cover one run, a last run of one page,
runs wholly past ``seq_len``, ``seq_len`` in the first page of the last run
and cuckoo runs that start on the unselected candidate.  The CUDA kernels
meet the same edges on the card in ``test_paged_kernels_on_card`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro.kernels.paged_attention import (cuckoo_paged_attention_kernel,
                                           paged_attention_kernel)
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("n_pages", [1, 2, 15, 16, 17, 33, 321, 1954, 31264,
                                     10**6, 2**30 - 1])
@pytest.mark.parametrize("n_kv,g,n_sm", [(1, 4, 132), (8, 4, 132), (8, 4, 1),
                                         (64, 8, 132), (8, 5, 132)])
def test_split_plan_covers_every_page_once(n_pages, n_kv, g, n_sm):
    split, n_splits = ops.paged_split_plan(n_pages, n_kv, g, n_sm)
    assert ops.PAGED_MIN_SPLIT_PAGES <= split <= ops.PAGED_MAX_SPLIT_PAGES
    assert 1 <= n_splits < 2**31  # the grid's x limit
    if n_pages <= 10**6:
        runs = ref.split_step_ranges(n_pages, split, 1)
        assert len(runs) == n_splits
        assert [a for a, _ in runs] == [0] + [b for _, b in runs[:-1]]
        assert runs[-1][1] == n_pages and all(b > a for a, b in runs)
        # cuckoo: both candidates (steps 2p, 2p + 1) in one run
        runs2 = ref.split_step_ranges(n_pages, split, 2)
        assert runs2 == [(2 * a, 2 * b) for a, b in runs]
    # the last run holds at least one page, and no run more than split
    assert (n_splits - 1) * split < n_pages <= n_splits * split


@pytest.mark.parametrize("n_pages", [1, 4, 16])
def test_split_plan_one_split_for_small_maps(n_pages):
    assert ops.paged_split_plan(n_pages, 8, 4, 132) == (16, 1)


def test_split_plan_serve_shape():
    """llama3.2-1b's attention at L = 1954 on 132 SMs: 98 runs of 20 pages,
    784 blocks, one wave of at most 6 an SM."""
    split, n_splits = ops.paged_split_plan(1954, 8, 4, 132)
    assert (split, n_splits) == (20, 98)
    assert 8 * n_splits <= ops.PAGED_BLOCKS_PER_SM * 132 < 8 * 4 * n_splits


def test_split_plan_long_maps_and_wide_groups():
    """Long maps take runs of 64 pages (the run's ids fit the block's
    shared memory); a group wider than 4 queries takes a block a tile of 4,
    so for the same blocks an SM its runs are longer."""
    assert ops.paged_split_plan(10**6, 8, 4, 132) == (64, 15625)
    assert ops.paged_split_plan(3000, 8, 8, 132) == (61, 50)
    assert ops.paged_split_plan(3000, 8, 4, 132) == (31, 97)


# --------------------------------------------------------- the decomposition
def _inputs(seed, n_kv, g, d, ps, L, dtype, starts=()):
    """numpy inputs for both packages; the cuckoo map's true page is
    candidate 1 at step 0 and at every page in ``starts``, so the run
    starting there begins on the unselected candidate."""
    rng = np.random.default_rng(seed)
    pool = 3 * L
    q = rng.standard_normal((n_kv, g, d)).astype(np.float32)
    k = rng.standard_normal((pool, ps, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((pool, ps, n_kv, d)).astype(np.float32)
    pm = rng.choice(pool, L, replace=False).astype(np.int32)
    decoy = rng.choice(pool, L, replace=False).astype(np.int32)
    sel = rng.integers(0, 2, L).astype(np.int32)
    sel[[0, *starts]] = 1
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


# (n_kv, g, d, ps, L, seq_len, dtype, split_pages)
SPLIT_CASES = [
    (2, 4, 64, 16, 1, 9, "float32", 16),          # L = 1: one run
    (2, 4, 64, 16, 4, 49, "float32", 16),         # one run, ragged page
    (2, 4, 64, 16, 9, 144, "float32", 4),         # last run of one page
    (2, 4, 64, 16, 9, 131, "float32", 4),         # seq_len in its first page
    (2, 4, 64, 16, 12, 20, "float32", 4),         # runs 1-2 wholly past
    (1, 8, 64, 16, 10, 150, "bfloat16", 3),       # bf16, ragged runs
    (4, 2, 128, 32, 7, 200, "float32", 2),        # d = 128
    (2, 4, 128, 16, 11, 170, "bfloat16", 5),      # d = 128, bf16
]


@pytest.mark.parametrize("n_kv,g,d,ps,L,seq_len,dtype,split", SPLIT_CASES)
def test_split_model_vs_pallas(n_kv, g, d, ps, L, seq_len, dtype, split):
    (jq, jk, jv), (tq, tk, tv), pm, _, _ = _inputs(
        10 + L, n_kv, g, d, ps, L, dtype)
    tpm = torch.from_numpy(pm)
    got = ref.combine_split_partials(
        *ref.paged_split_partials(tq, tk, tv, tpm, seq_len, split))
    want = paged_attention_kernel(jq, jk, jv, jnp.asarray(pm),
                                  jnp.asarray([seq_len], jnp.int32),
                                  interpret=True)
    _close(got, want)
    _close(got, r_ref.paged_attention_ref(jq, jk, jv, jnp.asarray(pm),
                                          jnp.int32(seq_len)))
    _close(got, ref.paged_attention_ref(tq, tk, tv, tpm, seq_len))


@pytest.mark.parametrize("n_kv,g,d,ps,L,seq_len,dtype,split", SPLIT_CASES)
def test_cuckoo_split_model_vs_pallas(n_kv, g, d, ps, L, seq_len, dtype,
                                      split):
    """Every run starts on the unselected candidate, so each run washes a
    decoy out as step 0 does."""
    (jq, jk, jv), (tq, tk, tv), _, pm2, sel = _inputs(
        20 + L, n_kv, g, d, ps, L, dtype, starts=range(0, L, split))
    got = ref.combine_split_partials(*ref.paged_split_partials(
        tq, tk, tv, torch.from_numpy(pm2), seq_len, split,
        select=torch.from_numpy(sel)))
    want = cuckoo_paged_attention_kernel(
        jq, jk, jv, jnp.asarray(pm2), jnp.asarray(sel),
        jnp.asarray([seq_len], jnp.int32), interpret=True)
    _close(got, want)
    true_pm = torch.from_numpy(pm2[np.arange(L), sel])
    _close(got, ref.paged_attention_ref(tq, tk, tv, true_pm, seq_len))


def test_runs_past_seq_len_end_at_the_sentinel_and_weigh_zero():
    """Runs whose tokens all lie past seq_len keep m = -1e30 (l counts
    their masked tokens); the combine gives them weight 0 exactly."""
    _, (q, k, v), pm, _, _ = _inputs(3, 2, 4, 64, 16, 12, "float32")
    tpm = torch.from_numpy(pm)
    acc, m, l = ref.paged_split_partials(q, k, v, tpm, 20, 4)
    assert acc.shape == (3, 2, 4, 64) and m.shape == l.shape == (3, 2, 4)
    assert torch.all(m[1:] == ref.NEG_SENTINEL)
    assert torch.all(l[1:] == 4 * 16)
    assert torch.all(torch.isfinite(acc))
    alone = ref.combine_split_partials(acc[:1], m[:1], l[:1])
    for a, b in zip(ref.combine_split_partials(acc, m, l), alone):
        assert torch.equal(a, b)


def test_unselected_first_step_of_a_run_washes_out():
    """A cuckoo run that starts on the decoy: m stays at the sentinel and l
    takes the decoy's 16 tokens in until the first valid step sets alpha to
    0; the run's partial equals the Ludo run's over the true pages."""
    _, (q, k, v), _, pm2, sel = _inputs(4, 2, 4, 64, 16, 8, "float32",
                                        starts=(4,))
    acc2, m2, l2 = ref.paged_split_partials(
        q, k, v, torch.from_numpy(pm2), 128, 4, select=torch.from_numpy(sel))
    true_pm = torch.from_numpy(np.ascontiguousarray(pm2[np.arange(8), sel]))
    acc1, m1, l1 = ref.paged_split_partials(q, k, v, true_pm, 128, 4)
    for a, b in ((acc2, acc1), (m2, m1), (l2, l1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_out_of_pool_page_reads_zero_tiles_and_is_masked():
    """A page id outside the pool, past seq_len, changes nothing."""
    _, (q, k, v), pm, _, _ = _inputs(5, 2, 4, 64, 16, 6, "float32")
    want = ref.paged_attention_ref(q, k, v, torch.from_numpy(pm), 70)
    for bad in (-1, k.shape[0], 2**31 - 1):
        pm_bad = pm.copy()
        pm_bad[5] = bad
        got = ref.combine_split_partials(*ref.paged_split_partials(
            q, k, v, torch.from_numpy(pm_bad), 70, 2))
        _close(got, want)


# ------------------------------------------------------------ the wrappers
# The CUDA kernels' limits are checked on the CUDA branch only
# (ops._check_paged_cuda); these tests call that check on CPU tensors, and
# tests/test_torch_cuda.py sees the wrappers raise it on CUDA tensors.  On
# the CPU the wrappers take the plain version, which has none of the limits.
def _cuda_check(q, k_pool, v_pool, n_pages, seq_len):
    ops._check_paged_cuda(ops._check_paged(q, k_pool, v_pool, n_pages,
                                           seq_len), k_pool, v_pool)


def test_paged_wrappers_reject_pools_off_16_byte_boundaries():
    """The kernel copies pages in 16-byte chunks, so both pools must start
    on a 16-byte boundary."""
    _, (q, k, v), pm, pm2, sel = _inputs(6, 2, 4, 64, 16, 4, "float32")
    flat = torch.zeros(k.numel() + 1)
    shifted = flat[1:].view(k.shape)  # 4 bytes past an aligned start
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    pm, pm2, sel = (torch.from_numpy(a) for a in (pm, pm2, sel))
    with pytest.raises(ValueError, match="16-byte"):
        _cuda_check(q, shifted, v, len(pm), 64)
    with pytest.raises(ValueError, match="16-byte"):
        _cuda_check(q, k, shifted, len(pm2), 64)
    # the plain version takes a pool at any start
    _close(ops.cuckoo_paged_attention(q, k, shifted, pm2, sel, 64),
           ops.cuckoo_paged_attention(q, k, shifted.clone(), pm2, sel, 64))


def test_paged_wrappers_reject_pages_beyond_shared_memory():
    """Two loop steps of K and V rows must fit a block's 227 KB: 256-token
    float32 pages of d = 128 need 512 KB."""
    q = torch.zeros((1, 4, 128))
    pool = torch.zeros((2, 256, 1, 128))
    pm = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared"):
        _cuda_check(q, pool, pool, 1, 1)
    # the plain version takes such pages
    o, m, l = ops.paged_attention(q, pool, pool, pm, 1)
    assert o.shape == (1, 4, 128) and torch.all(l == 1)
    o2, _, _ = ops.cuckoo_paged_attention(q, pool, pool, torch.zeros(
        (1, 2), dtype=torch.int32), pm, 1)
    assert torch.equal(o, o2)
    # 64-token float32 pages of d = 128 fit two steps, not four
    assert ops.paged_smem_bytes(2, 64, 128, 4) <= ops.PAGED_SMEM_LIMIT
    assert ops.paged_smem_bytes(4, 64, 128, 4) > ops.PAGED_SMEM_LIMIT


def test_paged_wrappers_reject_more_head_blocks_than_the_grid_takes():
    """The split pass puts KV heads x query tiles of 4 on the grid's y axis,
    at most 65535 of them."""
    for n_kv, g in ((65536, 1), (32768, 5)):
        q = torch.zeros((n_kv, g, 64))
        pool = torch.zeros((1, 1, n_kv, 64))
        with pytest.raises(ValueError, match="grid"):
            _cuda_check(q, pool, pool, 1, 1)
    q = torch.zeros((65535, 1, 64))  # the most it takes
    pool = torch.zeros((1, 1, 65535, 64))
    _cuda_check(q, pool, pool, 1, 1)
    o, m, l = ops.paged_attention(q, pool, pool,
                                  torch.zeros(1, dtype=torch.int32), 1)
    assert o.shape == (65535, 1, 64)


def test_paged_smem_at_the_serve_shape():
    """Four loop steps of two 16-token bf16 pages of d = 64 (llama3.2-1b's
    width): 32 KB of rows, small enough for 6 blocks an SM."""
    b = ops.paged_smem_bytes(ops.PAGED_MAX_STAGES, 16, 64, 2)
    assert b == 4 * 2 * 32 * 64 * 2 + 4 * 4 * 32 + 4 * (3 * 64 + 8)
    assert ops.PAGED_BLOCKS_PER_SM * b <= 228 * 1024
