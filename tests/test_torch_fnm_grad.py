"""The backward of the fused RMSNorm -> matmul, on the CPU.

The reference has no Pallas backward for ``fused_norm_matmul``: its model
computes ``rms_norm`` then the product, and XLA differentiates them.  The
port fuses the norm into one kernel, so it carries a backward of its own
(``csrc/fused_norm_matmul_bwd.cu``), whose plain version is
``ref.fused_norm_matmul_bwd_ref``.  Here that plain version is held:

* against ``torch.autograd`` of ``ref.fused_norm_matmul_ref`` (both in
  float32 from the same values: 1e-5 of each gradient's largest value in
  float32; bf16 outputs round once, 2^-8 of that value);
* against ``torch.autograd.gradcheck`` of the same function in float64;
* against ``jax.grad`` of the reference's ``rms_norm`` then ``@``, at the
  shapes of ``tests/test_kernels.py`` and ragged ones, with that file's
  tolerances (1e-4 in float32, 3e-2 in bf16, where the reference rounds
  the normalized rows to bf16 before the product and the port does not),
  each as the largest error over the gradient's largest value.

``ops.fused_norm_matmul_bwd_plan`` and the workspace size are pinned, and
so are ``ops.fused_norm_matmul_bwd_dw_plan`` (the regime, S-splits and row
pass of the kernels at the training entries and at ragged, unaligned and
float32 shapes) and dw's workspace.  ``ref.fused_norm_matmul_bwd_dw_splits``
models the ``wgmma`` regime's dw (A rounded once to bf16, float32 partials
over ranges of S summed in split order, one rounding) and is held against
the plain backward and ``jax.grad`` with the bf16 tolerance, 3e-2.
``ops.fused_norm_matmul`` goes through the autograd node ``FusedNormMatmul``
only when grad mode is on and an input requires grad; otherwise it makes no
node, and on the CPU no call counts a launch.  The kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import rms_norm as r_rms_norm
from repro_torch.kernels import ops, ref

SHAPES = [  # tests/test_kernels.py's, then ragged S, d and F
    (256, 512, 1024, "float32"), (512, 256, 512, "float32"),
    (128, 1024, 512, "bfloat16"), (7, 200, 100, "float32"),
    (9, 64, 131, "bfloat16"), (7, 2048, 1000, "float32"),
    (7, 2048, 1000, "bfloat16")]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # tests/test_kernels.py:138


def _inputs(seed, S, d, F, dtype):
    """tests/test_kernels.py's inputs and a cotangent dy: numpy float32,
    rounded to bf16 by each framework where asked."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((S, d)), rng.standard_normal((d,)),
            rng.standard_normal((d, F)) / np.sqrt(d),
            rng.standard_normal((S, F)))
    arrs = tuple(a.astype(np.float32) for a in arrs)
    return (tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs),
            tuple(torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs))


def _rel(got, want) -> float:
    """Largest error over the largest value of ``want``, in float32."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("S,d,F,dtype", SHAPES)
def test_bwd_ref_matches_autograd_of_the_forward(S, d, F, dtype):
    _, (x, g, w, dy) = _inputs(1, S, d, F, dtype)
    got = ref.fused_norm_matmul_bwd_ref(x, g, w, dy)
    leaves = [t.float().requires_grad_() for t in (x, g, w)]
    out = ref.fused_norm_matmul_ref(*leaves)
    want = torch.autograd.grad(out, leaves, dy.float())
    tol = 1e-5 if dtype == "float32" else 2**-8
    for name, a, b, t in zip(("dx", "dgamma", "dw"), got, want, (x, g, w)):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


def test_bwd_ref_passes_gradcheck_in_float64():
    class Fnm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, g, w):
            ctx.save_for_backward(x, g, w)
            return ref.fused_norm_matmul_ref(x, g, w)

        @staticmethod
        def backward(ctx, dy):
            return ref.fused_norm_matmul_bwd_ref(*ctx.saved_tensors, dy)

    gen = torch.Generator().manual_seed(0)
    x, g, w = (torch.randn(s, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for s in ((5, 12), (12,), (12, 7)))
    assert torch.autograd.gradcheck(Fnm.apply, (x, g, w))


@pytest.mark.parametrize("S,d,F,dtype", SHAPES)
def test_bwd_ref_matches_jax_grad_of_the_reference(S, d, F, dtype):
    (jx, jg, jw, jdy), (x, g, w, dy) = _inputs(2, S, d, F, dtype)

    def loss(x_, g_, w_):
        out = (r_rms_norm(x_, g_) @ w_).astype(jnp.float32)
        return jnp.sum(out * jdy.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jx, jg, jw)
    got = ref.fused_norm_matmul_bwd_ref(x, g, w, dy)
    for name, a, b in zip(("dx", "dgamma", "dw"), got, want):
        assert a.dtype == getattr(torch, dtype)
        assert _rel(a, b) <= TOL[dtype], (name, _rel(a, b))


def test_bwd_plan_and_workspace():
    assert ops.fused_norm_matmul_bwd_plan(2048, 132) == 8
    assert ops.fused_norm_matmul_bwd_plan(7, 132) == 1
    assert ops.fused_norm_matmul_bwd_plan(264, 132) == 1
    assert ops.fused_norm_matmul_bwd_plan(265, 132) == 2
    # r rounded up to 4 floats, then a row of d a block
    assert ops.fused_norm_matmul_bwd_workspace(7, 2048, 1) == 8 + 7 * 2048
    assert ops.fused_norm_matmul_bwd_workspace(2048, 2048, 8) == \
        2048 + 256 * 2048


def test_autograd_node_only_when_a_gradient_is_asked_for():
    _, (x, g, w, dy) = _inputs(4, 9, 64, 131, "float32")
    ops.reset_launch_counts()
    assert ops.fused_norm_matmul(x, g, w).grad_fn is None
    wl = w.clone().requires_grad_()
    with torch.no_grad():
        assert ops.fused_norm_matmul(x, g, wl).grad_fn is None
    out = ops.fused_norm_matmul(x, g, wl)
    assert type(out.grad_fn).__name__ == "FusedNormMatmulBackward"
    torch.testing.assert_close(out.detach(), ops.fused_norm_matmul(x, g, w),
                               rtol=0, atol=0)
    # only w asked for: the node returns its gradient and no other
    (dw,) = torch.autograd.grad(out, (wl,), dy)
    torch.testing.assert_close(dw, ref.fused_norm_matmul_bwd_ref(
        x, g, w, dy)[2], rtol=0, atol=0)
    xl, gl = x.clone().requires_grad_(), g.clone().requires_grad_()
    got = torch.autograd.grad(ops.fused_norm_matmul(xl, gl, wl), (xl, gl, wl),
                              dy)
    for a, b in zip(got, ref.fused_norm_matmul_bwd_ref(x, g, w, dy)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not any(ops.LAUNCHES.values())


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    _, (x, g, w, dy) = _inputs(5, 8, 64, 96, "float32")
    assert all(a.shape == b.shape for a, b in zip(
        ops.fused_norm_matmul_bwd(x, g, w, dy), (x, g, w)))
    with pytest.raises(TypeError):  # dy of another dtype
        ops.fused_norm_matmul_bwd(x, g, w, dy.bfloat16())
    with pytest.raises(TypeError):
        ops.fused_norm_matmul_bwd(x, g, w, dy.numpy())
    with pytest.raises(ValueError):  # dy of another shape
        ops.fused_norm_matmul_bwd(x, g, w, dy[:, :64].contiguous())
    with pytest.raises(ValueError):  # non-contiguous dy
        ops.fused_norm_matmul_bwd(x, g, w, dy.t().contiguous().t())
    with pytest.raises(ValueError):  # dy on another device
        ops.fused_norm_matmul_bwd(x, g, w, dy.to("meta"))
    with pytest.raises(TypeError):  # the forward's checks
        ops.fused_norm_matmul_bwd(x, g.bfloat16(), w, dy)
    with pytest.raises(ValueError):
        ops.fused_norm_matmul_bwd(x, g, w[:32].contiguous(), dy)


TRAIN_ENTRIES = [(2048, 2048, f) for f in (2048, 512, 512, 8192, 8192)]


def _tiles(d, F, tile):
    return -(-d // tile[0]) * -(-F // tile[1])


@pytest.mark.parametrize("S,d,F", TRAIN_ENTRIES)
def test_bwd_dw_plan_at_the_training_entries(S, d, F):
    """llama3.2-1b's five entries: bf16 on the tensor cores, rows of 4 KB
    kept in registers, tiles of 128 x 256 where they fill half of 132 SMs
    (F = 2048 and 8192) else 128 x 128, and as many S-splits as one wave
    holds (F = 512: 64 tiles, 2 splits, 128 blocks)."""
    plan = ops.fused_norm_matmul_bwd_dw_plan(S, d, F, 2, 132)
    assert plan["regime"] == "wgmma" and not plan["reread"]
    assert ops.FNM_BWD_WGMMA_TILE == (128, 256)
    assert plan["tile"] == {2048: (128, 256), 512: (128, 128),
                            8192: (128, 256)}[F]
    wide = _tiles(d, F, ops.FNM_BWD_WGMMA_TILE)
    assert (plan["tile"] == ops.FNM_BWD_WGMMA_TILE) == (2 * wide > 132)
    tiles, n = _tiles(d, F, plan["tile"]), plan["splits"]
    assert n == {2048: 1, 512: 2, 8192: 1}[F]
    assert n == 1 or tiles * n <= 132 < tiles * (n + 1)


@pytest.mark.parametrize("S,d,F,elt,aligned,want", [
    (9, 64, 131, 2, True, ("mma", 128, 1, False)),  # dy rows not 16 bytes
    (96, 256, 512, 2, False, ("mma", 128, 1, False)),  # dy off a 16-byte line
    (7, 2048, 1000, 2, True, ("wgmma", 128, 1, False)),  # one step
    (200, 640, 384, 2, True, ("wgmma", 128, 4, False)),  # 15 tiles, 4 steps
    (128, 1024, 512, 2, True, ("wgmma", 128, 2, False)),  # 32 tiles, 2 steps
    (300, 1100, 1800, 2, True, ("wgmma", 256, 1, False)),  # 72 wide tiles
    (64, 2304, 256, 2, True, ("wgmma", 128, 1, True)),  # a row past 4 KB
    (33, 2304, 131, 2, True, ("mma", 128, 1, True)),
    (256, 512, 1024, 4, True, ("fma", 128, 1, False)),
    (2048, 2048, 8192, 4, True, ("fma", 128, 1, True)),  # 8 KB rows
])
def test_bwd_dw_plan_at_ragged_unaligned_and_float32_shapes(S, d, F, elt,
                                                           aligned, want):
    plan = ops.fused_norm_matmul_bwd_dw_plan(S, d, F, elt, 132, aligned)
    assert (plan["regime"], plan["tile"][1], plan["splits"],
            plan["reread"]) == want
    assert plan["tile"][0] == 128
    if want[0] == "wgmma":  # every split has a step; more need more steps
        steps = -(-S // ops.FNM_BWD_STEP)
        per = -(-steps // plan["splits"])
        assert (plan["splits"] - 1) * per < steps
        tiles = _tiles(d, F, plan["tile"])
        assert plan["splits"] == min(steps, 132 // tiles) \
            or plan["splits"] == ops.FNM_BWD_MAX_SPLITS


def test_bwd_dw_workspace():
    """A of (S, d rounded up to 64) bf16 in floats, then the partials of
    a split plan; nothing outside the wgmma regime."""
    plan = ops.fused_norm_matmul_bwd_dw_plan(2048, 2048, 512, 2, 132)
    assert ops.fused_norm_matmul_bwd_dw_workspace(plan, 2048, 2048, 512) \
        == 2048 * 2048 // 2 + 2 * 2048 * 512
    plan = ops.fused_norm_matmul_bwd_dw_plan(2048, 2048, 8192, 2, 132)
    assert ops.fused_norm_matmul_bwd_dw_workspace(plan, 2048, 2048, 8192) \
        == 2048 * 2048 // 2
    plan = ops.fused_norm_matmul_bwd_dw_plan(100, 1004, 256, 2, 132)
    assert plan["splits"] == 2
    assert ops.fused_norm_matmul_bwd_dw_workspace(plan, 100, 1004, 256) \
        == 100 * 1024 // 2 + 2 * 1004 * 256
    for elt, aligned in ((2, False), (4, True)):
        plan = ops.fused_norm_matmul_bwd_dw_plan(96, 256, 512, elt, 132,
                                                 aligned)
        assert ops.fused_norm_matmul_bwd_dw_workspace(plan, 96, 256, 512) == 0


@pytest.mark.parametrize("S,d,F,splits", [
    (200, 96, 64, 4), (128, 64, 40, 2), (7, 32, 16, 1)])
def test_bwd_dw_split_order_matches_the_reference_and_jax(S, d, F, splits):
    (jx, jg, jw, jdy), (x, g, w, dy) = _inputs(6, S, d, F, "bfloat16")
    got, parts = ref.fused_norm_matmul_bwd_dw_splits(x, g, dy, splits)
    assert got.dtype == torch.bfloat16 and parts.shape == (splits, d, F)
    tot = parts[0]
    for p in parts[1:]:  # split order, one rounding
        tot = tot + p
    assert torch.equal(got, tot.to(torch.bfloat16))
    # each split covers whole steps of 64 rows, the last the rest
    per = -(-(-(-S // 64)) // splits) * 64
    xf = x.float()
    a = (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
         * g.float()).to(torch.bfloat16).float()
    torch.testing.assert_close(parts[-1], a[(splits - 1) * per:].T
                               @ dy.float()[(splits - 1) * per:],
                               rtol=0, atol=0)
    want = ref.fused_norm_matmul_bwd_ref(x, g, w, dy)[2]
    assert _rel(got, want) <= TOL["bfloat16"]

    def loss(w_):
        out = (r_rms_norm(jx, jg) @ w_).astype(jnp.float32)
        return jnp.sum(out * jdy.astype(jnp.float32))

    assert _rel(got, jax.grad(loss)(jw)) <= TOL["bfloat16"]
