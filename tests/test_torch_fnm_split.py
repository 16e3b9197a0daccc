"""The fused RMSNorm -> matmul kernel's decomposition and plan, on the CPU.

``csrc/fused_norm_matmul.cu`` factors the norm out of the dot: up to 32
rows of x it streams w in K-splits whose float32 partials (and partial sums
of x^2) a combine pass adds in split order; more rows take a tiled product
of x * gamma (rounded to bf16 for the tensor cores), which a rows pass
writes with the inverse RMS.  ``ops.fused_norm_matmul_plan`` picks the
regime and the splits, and for the tensor cores the tile, the cluster and
the persistent grid whose walk ``ops.fused_norm_matmul_walk`` lists; they
are pinned here at llama3.2-1b's serve shapes and at the training
entries.  The plain models
of ``ref.py`` (``fused_norm_matmul_split_partials`` with
``combine_fused_norm_matmul_partials``, and ``fused_norm_matmul_rows``) are
held against ``repro``'s Pallas ``fused_norm_matmul_kernel`` in interpret
mode and against ``fused_norm_matmul_ref`` with the tolerances of
``tests/test_kernels.py`` (1e-4 in float32, 3e-2 in bf16): the same float32
products, summed in another order, and in bf16 one more rounding of
x * gamma, 2^-9 relative, well inside 3e-2.  The CUDA kernels meet the same
edges on the card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro.kernels.fused_norm_matmul import fused_norm_matmul_kernel
from repro_torch.kernels import ops, ref

TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # tests/test_kernels.py:138
ELT = {"float32": 4, "bfloat16": 2}


def _inputs(seed, S, d, F, dtype):
    """tests/test_kernels.py's inputs: numpy float32, rounded to bf16 by
    each framework where asked."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((S, d)), rng.standard_normal((d,)),
            rng.standard_normal((d, F)) / np.sqrt(d))
    arrs = tuple(a.astype(np.float32) for a in arrs)
    return (tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs),
            tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs))


# ------------------------------------------------------------------ the plan
SERVE = {  # llama3.2-1b's five decode entries (S = 8 lanes, d = 2048), bf16
    2048: ("mma", 128, 8, 256),   # wq: 16 column tiles x 8 splits
    512: ("mma", 128, 16, 128),   # wk, wv: 4 x 16
    8192: ("mma", 128, 4, 512),   # w_gate, w_up: 64 x 4
}


@pytest.mark.parametrize("F", sorted(SERVE))
def test_plan_at_the_serve_shapes(F):
    """About a block an SM at the decode entries on 132 SMs, in splits of
    128 to 512 rows of d."""
    p = ops.fused_norm_matmul_plan(8, 2048, F, 2, 132)
    assert (p["regime"], p["tile"], p["splits"], p["krange"]) == SERVE[F]
    n = p["splits"]
    assert ops.fused_norm_matmul_workspace(p, 8, 2048, F, 2) \
        == n * 8 * F + n * 8


def test_plan_at_the_prefill_shape():
    """S = 256: one group of two row tiles; 64 column tiles of 128 fill the
    card's 66 clusters once, where 32 of 256 would leave half idle."""
    assert ops.fused_norm_matmul_plan(256, 2048, 8192, 2, 132) == dict(
        regime="wgmma", tile=(128, 128), splits=1, krange=2048, cluster=2,
        ctas=128, walk="s")
    assert ops.fused_norm_matmul_plan(256, 2048, 8192, 4, 132) == dict(
        regime="fma", tile=(64, 64), splits=1, krange=2048)


TRAIN = {  # (d, F) at S = 2048 rows, bf16 -> (tile columns, cluster, CTAs)
    (2560, 4096): (256, 2, 132),  # qwen3-4b's wq: 128 tiles, 2 rounds
    (2560, 1024): (128, 2, 128),  # wk, wv: 64 tiles of 128, one round
    (2560, 9728): (256, 2, 132),  # w_gate, w_up: 304 tiles, 4.6 rounds
    (2048, 2048): (256, 2, 128),  # llama3.2-1b's wq: 64 tiles, one round
    (2048, 512): (128, 2, 64),    # wk, wv: 32 tiles of 128
    (2048, 8192): (256, 2, 132),  # w_gate, w_up: 256 tiles
}


@pytest.mark.parametrize("d,F", sorted(TRAIN))
def test_plan_at_the_training_shapes(d, F):
    """The training entries of qwen3-4b and llama3.2-1b on 132 SMs: the
    tile whose rounds over the 66 clusters cost least (the wider on a tie),
    clusters of two row tiles, a CTA an SM or one a cluster tile."""
    p = ops.fused_norm_matmul_plan(2048, d, F, 2, 132)
    assert p["regime"] == "wgmma" and p["splits"] == 1 and p["krange"] == d
    assert (p["tile"][1], p["cluster"], p["ctas"]) == TRAIN[d, F]
    assert p["tile"][0] == 128 and p["walk"] == "s"
    # bf16 x * gamma of 2048 rows of d (a multiple of 64), then 2048 floats
    assert ops.fused_norm_matmul_workspace(p, 2048, d, F, 2) \
        == 2048 * d // 2 + 2048


@pytest.mark.parametrize("S,F", [(2048, 9728), (2048, 1024), (2049, 9736),
                                 (33, 4096), (129, 131 * 8), (256, 8192),
                                 (300, 100 * 8), (6000, 5120)])
def test_walk_covers_every_tile_once(S, F):
    """Every output tile is computed by exactly one CTA on any card of 1 to
    132 SMs; a cluster's CTAs walk the same column tiles in the same order
    (a cluster never straddles two column tiles of F), rank r the row tile
    r of its group; tiles past S are only partners of the last group."""
    for n_sm in range(1, 133):
        p = ops.fused_norm_matmul_plan(S, 1000, F, 2, n_sm)
        rows, cols = p["tile"]
        cm, ctas = p["cluster"], p["ctas"]
        assert ctas % cm == 0 and cm <= ctas <= max(n_sm, cm)
        assert cm == (2 if S > 128 and n_sm >= 2 else 1)
        walk = ops.fused_norm_matmul_walk(p, S, F)
        assert len(walk) == ctas
        seen = [t for cta in walk for t in cta if t[0] < S]
        want = {(m, n) for m in range(0, S, rows) for n in range(0, F, cols)}
        assert len(seen) == len(want) and set(seen) == want
        m_tiles = -(-S // rows)
        for c in range(0, ctas, cm):
            lead = walk[c]
            for r in range(cm):
                cta = walk[c + r]
                assert [n for _, n in cta] == [n for _, n in lead]
                assert all(m // rows % cm == r for m, _ in cta)
                assert all(m // rows < m_tiles or (r == cm - 1 and
                                                   m_tiles % cm)
                           for m, _ in cta)
        # S first: the clusters' first tiles are the first tiles of the
        # grid, all the groups of a column tile before the next column tile
        groups = -(-m_tiles // cm)
        firsts = [walk[c][0] for c in range(0, ctas, cm) if walk[c]]
        assert firsts == [((i % groups) * cm * rows, i // groups * cols)
                          for i in range(len(firsts))]


@pytest.mark.parametrize("S,d,F", [(33, 1000, 4096), (2048, 2560, 9728),
                                   (2049, 2568, 1024), (64, 64, 64),
                                   (300, 1004, 1024), (40, 7, 8)])
def test_wgmma_workspace_size(S, d, F):
    """The rows pass's x * gamma in bf16, S rows of d padded to 64, then S
    floats of the inverse RMS, whatever the tile and cluster."""
    p = ops.fused_norm_matmul_plan(S, d, F, 2, 132)
    dp = -(-d // 64) * 64
    assert p["regime"] == "wgmma"
    assert ops.fused_norm_matmul_workspace(p, S, d, F, 2) == S * dp // 2 + S


@pytest.mark.parametrize("n_sm,F,want", [
    (1, 2048, (4, 512)), (16, 2048, (4, 512)), (16, 512, (4, 512)),
    (32, 512, (8, 256)), (1, 8192, (4, 512)), (264, 2048, (16, 128))])
def test_plan_on_small_cards(n_sm, F, want):
    """A card with fewer SMs gets fewer splits (about a block an SM), but a
    split holds at most 512 rows of d (its x * gamma in shared memory)."""
    p = ops.fused_norm_matmul_plan(8, 2048, F, 2, n_sm)
    assert (p["splits"], p["krange"]) == want


@pytest.mark.parametrize("S,F,elt,aligned,regime", [
    (8, 8192, 2, True, "mma"), (32, 8192, 2, True, "mma"),
    (33, 8192, 2, True, "wgmma"), (32, 8192, 4, True, "stream"),
    (33, 8192, 4, True, "fma"), (33, 100, 2, True, "stream"),
    (33, 100, 4, True, "fma"), (64, 131, 4, True, "stream"),
    (64, 1, 2, True, "stream"), (8, 8192, 2, False, "stream"),
    (256, 8192, 2, False, "stream")])
def test_plan_regime_boundaries(S, F, elt, aligned, regime):
    """Up to 32 rows the tensor cores in bf16 (mma) and the CUDA cores in
    float32 (stream); over 32 the tiled regimes.  A w row that is not whole
    16-byte chunks (100 bf16 columns, 131 of either type, one column) or
    w off a 16-byte boundary takes the stream regime at any S."""
    assert ops.fused_norm_matmul_plan(S, 1000, F, elt, 132,
                                      aligned)["regime"] == regime


@pytest.mark.parametrize("d", [1, 31, 32, 1000, 2048, 8192, 20000])
@pytest.mark.parametrize("S,F,elt,n_sm", [(8, 512, 2, 132), (1, 1, 4, 132),
                                          (32, 8192, 2, 132), (8, 100, 2, 1),
                                          (9, 131, 4, 132), (8, 8192, 4, 8)])
def test_plan_covers_d_once(d, S, F, elt, n_sm):
    p = ops.fused_norm_matmul_plan(S, d, F, elt, n_sm)
    k, n = p["krange"], p["splits"]
    if p["regime"] == "mma":
        assert p["tile"] == 128 and k % ops.FNM_MMA_KRANGE_UNIT == 0
        assert n <= max(ops.FNM_MMA_MAX_SPLITS, -(-d // ops.FNM_MAX_KRANGE))
    else:
        assert p["regime"] == "stream"
        assert p["tile"] * elt == ops.FNM_ROW_BYTES
        assert k % ops.FNM_KRANGE_UNIT == 0
        assert n <= max(ops.FNM_MAX_SPLITS, -(-d // ops.FNM_MAX_KRANGE))
    assert k <= ops.FNM_MAX_KRANGE
    assert (n - 1) * k < d <= n * k  # every split holds at least one row


def test_workspace_sizes():
    one = ops.fused_norm_matmul_plan(8, 32, 96, 4, 132)
    assert one["splits"] == 1
    assert ops.fused_norm_matmul_workspace(one, 8, 32, 96, 4) == 0
    st = ops.fused_norm_matmul_plan(8, 2048, 2048, 4, 132)
    assert st["regime"] == "stream" and st["splits"] == 8
    assert ops.fused_norm_matmul_workspace(st, 8, 2048, 2048, 4) \
        == 8 * 8 * 2048 + 8 * 8
    pre = ops.fused_norm_matmul_plan(256, 1000, 8192, 2, 132)
    # bf16 x * gamma of 256 rows of 1024 columns, then 256 floats
    assert ops.fused_norm_matmul_workspace(pre, 256, 1000, 8192, 2) \
        == 256 * 1024 // 2 + 256


# --------------------------------------------------------- the decomposition
# (S, d, F, dtype): tests/test_kernels.py's shapes and the ragged ones of
# tests/test_torch_kernels.py, then the split edges: S across the row
# groups of 8 and the stream / prefill boundary at 32, d = 1000 (no
# multiple of any K-split), F of one column, 100 and 131 columns.
MODEL_SHAPES = [
    (256, 512, 1024, "float32"), (512, 256, 512, "float32"),
    (128, 1024, 512, "bfloat16"), (7, 200, 100, "float32"),
    (9, 64, 131, "bfloat16"),
    (1, 1000, 1, "float32"), (7, 1000, 100, "bfloat16"),
    (8, 1000, 131, "float32"), (9, 1000, 512, "bfloat16"),
    (31, 1000, 100, "float32"), (32, 1000, 131, "bfloat16"),
    (33, 1000, 512, "float32"), (64, 1000, 100, "bfloat16"),
]


@pytest.mark.parametrize("S,d,F,dtype", MODEL_SHAPES)
def test_split_model_vs_pallas(S, d, F, dtype):
    """The stream regime's split partials and combine, at the plan's
    krange for 132 SMs and at one split, against the Pallas kernel."""
    (jx, jg, jw), (tx, tg, tw) = _inputs(30 + S, S, d, F, dtype)
    want = np.asarray(fused_norm_matmul_kernel(jx, jg, jw, block_s=S,
                                               block_f=F, interpret=True),
                      np.float32)
    krange = ops.fused_norm_matmul_plan(min(S, 32), d, F, ELT[dtype],
                                        132)["krange"]  # mma or stream
    tol = TOL[dtype]
    for k in (krange, d):
        part, ss = ref.fused_norm_matmul_split_partials(tx, tg, tw, k)
        assert part.shape == (-(-d // k), S, F) and ss.shape == (-(-d // k), S)
        got = ref.combine_fused_norm_matmul_partials(part, ss, d,
                                                     dtype=tx.dtype)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(
            got.float().numpy(),
            ref.fused_norm_matmul_ref(tx, tg, tw).float().numpy(),
            rtol=tol, atol=tol)


@pytest.mark.parametrize("S,d,F,dtype", MODEL_SHAPES)
def test_rows_model_vs_pallas(S, d, F, dtype):
    """The prefill regimes: x * gamma rounded once to the input type (bf16
    for the tensor cores; float32 for the FMA tile), rows padded to 64,
    inv_rms applied to the float32 product."""
    (jx, jg, jw), (tx, tg, tw) = _inputs(40 + S, S, d, F, dtype)
    xg, inv = ref.fused_norm_matmul_rows(tx, tg, tx.dtype)
    dp = xg.shape[1]
    assert dp % 64 == 0 and dp - 64 < d <= dp
    assert torch.all(xg[:, d:] == 0) and inv.dtype == torch.float32
    wpad = torch.zeros((dp, F))
    wpad[:d] = tw.float()
    got = (inv[:, None] * (xg.float() @ wpad)).to(tx.dtype)
    want = np.asarray(r_ref.fused_norm_matmul_ref(jx, jg, jw), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_split_sums_of_squares_add_up_to_the_row():
    _, (x, g, w) = _inputs(5, 9, 1000, 40, "float32")
    part, ss = ref.fused_norm_matmul_split_partials(x, g, w, 96)
    assert part.shape == (11, 9, 40)  # 10 splits of 96 rows and one of 40
    torch.testing.assert_close(ss.sum(dim=0), (x * x).sum(dim=1),
                               rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(part.sum(dim=0), (x * g) @ w, rtol=1e-5,
                               atol=1e-5)


def test_combine_is_the_split_order_and_deterministic():
    """Two combines of the same partials give the same bits; reversing the
    split order changes at most the last bits."""
    _, (x, g, w) = _inputs(6, 8, 2048, 512, "float32")
    part, ss = ref.fused_norm_matmul_split_partials(x, g, w, 128)
    a = ref.combine_fused_norm_matmul_partials(part, ss, 2048)
    b = ref.combine_fused_norm_matmul_partials(part, ss, 2048)
    assert torch.equal(a, b)
    c = ref.combine_fused_norm_matmul_partials(part.flip(0), ss.flip(0), 2048)
    torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
