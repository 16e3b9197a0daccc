"""The fused RMSNorm -> matmul kernel's decomposition and plan, on the CPU.

``csrc/fused_norm_matmul.cu`` factors the norm out of the dot: up to 32
rows of x it streams w in K-splits whose float32 partials (and partial sums
of x^2) a combine pass adds in split order; more rows take a rows pass
(x * gamma, rounded to bf16 for the tensor cores, and the inverse RMS) and
a tiled product.  ``ops.fused_norm_matmul_plan`` picks the regime and the
splits; it is pinned here at llama3.2-1b's serve shapes.  The plain models
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
    assert ops.fused_norm_matmul_plan(256, 2048, 8192, 2, 132) == dict(
        regime="wgmma", tile=(128, 128), splits=1, krange=2048)
    assert ops.fused_norm_matmul_plan(256, 2048, 8192, 4, 132) == dict(
        regime="fma", tile=(64, 64), splits=1, krange=2048)


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
