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

``ops.fused_norm_matmul_bwd_plan`` and the workspace size are pinned.
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
