"""The port's MoE block (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the CPU.

The same inputs, made from a seed with numpy, go through both packages'
functions with the reduced mixtral-8x22b (softmax scores, 4 experts, top
2) and deepseek-v3-671b (sigmoid scores, 8 experts, top 2, one shared
expert) configs.  Tolerances, as rtol and atol alike, are those of
``tests/test_torch_models.py``: float32 1e-5 (both sides compute in
float32 from identical values; only the order of the sums differs), bf16
5e-2 (the products round to bf16 where XLA may fuse).  Routing is held
exactly: the indices are equal in both dtypes (the router takes the same
rounded input in float32), the weights within 1e-6, and the capacity
binning drops the same picks.  ``top_k`` on a tied row takes the lower
index first, as ``jax.lax.top_k``.  The binned dispatch's gradients match
``jax.grad`` of the reference's (float32, 1e-4 of each gradient's largest
value: ``tests/test_torch_train.py``'s gradient tolerance), and its
hand-written dispatch and combine backwards (gathers summed in lane order,
no atomics) equal autograd of a plain gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as r_get_config
from repro.models import moe as r_moe
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.common import rms_norm

ARCHS = ["mixtral-8x22b", "deepseek-v3-671b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _cfgs(arch):
    return r_get_config(arch, reduced=True), get_config(arch, reduced=True)


def _inputs(cfg, dtype, B=2, S=12, seed=0):
    """Seeded numpy x (B, S, d) and MoE weights, as (jax, torch) trees in
    ``dtype``."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    arrs = {"x": rng.standard_normal((B, S, d))}
    for k, s in moe.moe_params_shape(cfg).items():
        arrs[k] = rng.standard_normal(s) / np.sqrt(s[-2])
    arrs = {k: a.astype(np.float32) for k, a in arrs.items()}
    jx = {k: jnp.asarray(a, getattr(jnp, dtype)) for k, a in arrs.items()}
    tx = {k: torch.from_numpy(a).to(getattr(torch, dtype))
          for k, a in arrs.items()}
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _ref_bins(idx, E, C):
    """The reference's binning arrays, its lines (``repro/models/moe.py``,
    ``moe_apply_binned``) over an index array: (lane_tok, dest in
    (token, choice) order)."""
    T, k = idx.shape
    flat_e = jnp.asarray(idx).reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = jnp.searchsorted(sorted_e, jnp.arange(E))
    pos = jnp.arange(T * k) - start[sorted_e]
    dest = jnp.where(pos < C, sorted_e * C + pos, E * C)
    lane_tok = jnp.full((E * C,), T, jnp.int32).at[dest].set(
        (order // k).astype(jnp.int32), mode="drop")
    dest_tk = jnp.zeros_like(dest).at[order].set(dest)
    return np.asarray(lane_tok), np.asarray(dest_tk)


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_matches_reference(arch, dtype):
    rc, tc = _cfgs(arch)
    jx, tx = _inputs(tc, dtype)
    rw, ridx, rs = r_moe.router_probs(jx, jx["x"], rc)
    tw, tidx, ts = moe.router_probs(tx, tx["x"], tc)
    assert tidx.shape == ridx.shape and tw.dtype == torch.float32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(ridx))
    _close(tw, rw, 1e-6)
    _close(ts, rs, 1e-6)


def test_top_k_takes_the_lower_index_on_ties():
    """A tied row: ``jax.lax.top_k`` and the port's ``top_k`` both take
    the lower index first among equal scores."""
    row = np.array([[0.5, 0.7, 0.5, 0.7, 0.1, 0.7],
                    [0.2, 0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3, 4, 6):
        rv, ri = jax.lax.top_k(jnp.asarray(row), k)
        tv, ti = moe.top_k(torch.from_numpy(row), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    assert moe.top_k(torch.from_numpy(row), 3)[1].tolist() == \
        [[1, 3, 5], [0, 1, 2]]


@pytest.mark.parametrize("arch", ARCHS)
def test_load_balance_loss_matches_reference(arch):
    rc, tc = _cfgs(arch)
    jx, tx = _inputs(tc, "float32", S=16)
    _, ridx, rs = r_moe.router_probs(jx, jx["x"], rc)
    _, tidx, ts = moe.router_probs(tx, tx["x"], tc)
    want = r_moe.load_balance_loss(rs, ridx, rc.moe.num_experts)
    got = moe.load_balance_loss(ts, tidx, tc.moe.num_experts)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ----------------------------------------------------------------- dispatch
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dtype):
    rc, tc = _cfgs(arch)
    jx, tx = _inputs(tc, dtype)
    rout, raux = r_moe.moe_apply(jx, jx["x"], rc)
    tout, taux = moe.moe_apply(tx, tx["x"], tc)
    assert tout.dtype == getattr(torch, dtype) and tout.shape == tx["x"].shape
    _close(tout, rout, TOL[dtype])
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity_factor", [0.5, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_binned_matches_reference(arch, capacity_factor, dtype):
    """At capacity factor 0.5 (T = 64 tokens: C = 16 lanes an expert
    against about 32 picks) picks drop, and they are the reference's; at 16
    nothing drops."""
    rc, tc = _cfgs(arch)
    jx, tx = _inputs(tc, dtype, B=4, S=16, seed=1)
    T, k, E = 64, tc.moe.top_k, tc.moe.num_experts
    C = max(8, int(T * k / E * capacity_factor))
    rout, raux = r_moe.moe_apply_binned(jx, jx["x"], rc,
                                        capacity_factor=capacity_factor)
    tout, taux = moe.moe_apply_binned(tx, tx["x"], tc,
                                      capacity_factor=capacity_factor)
    _close(tout, rout, TOL[dtype])
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6)
    _, idx, _ = moe.router_probs(tx, tx["x"], tc)
    lane_tok, dest = moe.bins(idx.reshape(T, k), E, C)
    want_tok, want_dest = _ref_bins(idx.reshape(T, k).numpy(), E, C)
    np.testing.assert_array_equal(lane_tok.numpy(), want_tok)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    dropped = int((dest == E * C).sum())
    assert (dropped > 0) == (capacity_factor < 1)


@settings(deadline=None, max_examples=20)
@given(st.integers(1, 40), st.integers(1, 4), st.integers(1, 9),
       st.integers(1, 12), st.integers(0, 2**31 - 1))
def test_bins_match_the_reference_binning(T, k, E, C, seed):
    """Random picks (repeats within a token allowed): every lane's token
    and every pick's lane, dropped ones included, as the reference's."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, E, (T, k))
    lane_tok, dest = moe.bins(torch.from_numpy(idx), E, C)
    want_tok, want_dest = _ref_bins(idx, E, C)
    np.testing.assert_array_equal(lane_tok.numpy(), want_tok)
    np.testing.assert_array_equal(dest.numpy(), want_dest)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gather_apply_matches_reference(arch, dtype, stacked):
    rc, tc = _cfgs(arch)
    jx, tx = _inputs(tc, dtype, B=3, S=1)
    kw_r, kw_t = {}, {}
    if stacked:  # the layer-stacked banks, layer 1 of 2
        banks = ("w_gate", "w_up", "w_down")
        kw_r = dict(stacks={b: jnp.stack([jx[b] * 2, jx[b]]) for b in banks},
                    layer_idx=1)
        kw_t = dict(stacks={b: torch.stack([tx[b] * 2, tx[b]])
                            for b in banks}, layer_idx=1)
    rout, raux = r_moe.moe_gather_apply(jx, jx["x"], rc, **kw_r)
    tout, taux = moe.moe_gather_apply(tx, tx["x"], tc, **kw_t)
    _close(tout, rout, TOL[dtype])
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6)
    # the gather form computes what the binned form does
    bout, _ = moe.moe_apply_binned(tx, tx["x"], tc, capacity_factor=16.0)
    _close(tout, bout.float(), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_expert_matches_reference(dtype):
    """deepseek's shared expert: the plain form of the normalized rows, and
    the fused form of the un-normalized rows with the norm's gamma,
    against the reference's ``(silu(h @ s_gate) * (h @ s_up)) @ s_down``
    of ``h = rms_norm(x)``."""
    from repro.models.common import rms_norm as r_rms_norm, silu as r_silu
    _, tc = _cfgs("deepseek-v3-671b")
    jx, tx = _inputs(tc, dtype)
    d = tc.d_model
    rng = np.random.default_rng(7)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jg = jnp.asarray(gamma, getattr(jnp, dtype))
    tg = torch.from_numpy(gamma).to(getattr(torch, dtype))
    h = r_rms_norm(jx["x"], jg).reshape(-1, d)
    want = (r_silu(h @ jx["s_gate"]) * (h @ jx["s_up"])) @ jx["s_down"]
    rows = tx["x"].reshape(-1, d)
    plain = moe.shared_expert(tx, rms_norm(rows, tg))
    fused = moe.shared_expert(tx, None, norm_in=(rows, tg))
    for got in (plain, fused):
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, TOL[dtype])


# ---------------------------------------------------------------- gradients
@pytest.mark.parametrize("capacity_factor", [0.5, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_binned_grads_match_jax(arch, capacity_factor):
    """d/d(x, weights) of sum(out * cot) + aux through the binned dispatch,
    float32, against ``jax.grad`` of the reference's."""
    rc, tc = _cfgs(arch)
    jx, tx = _inputs(tc, "float32", B=4, S=16, seed=2)
    cot = np.random.default_rng(3).standard_normal(
        tuple(tx["x"].shape)).astype(np.float32)

    def r_loss(p):
        out, aux = r_moe.moe_apply_binned(p, p["x"], rc,
                                          capacity_factor=capacity_factor)
        return jnp.sum(out * cot) + aux

    want = jax.grad(r_loss)(jx)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tx.items()}
    out, aux = moe.moe_apply_binned(leaves, leaves["x"], tc,
                                    capacity_factor=capacity_factor)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    for k, t in leaves.items():
        w = np.asarray(want[k])
        err = float(np.abs(t.grad.numpy() - w).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(w).max())), (k, err)


def test_dispatch_and_combine_backwards_equal_autograd_of_gathers():
    """The hand-written backwards (a token's lanes gathered and summed in
    lane order) against autograd of the plain gathers (index_put
    accumulation), float32, with picks dropped."""
    torch.manual_seed(0)
    T, k, E, C, d = 24, 3, 5, 8, 6
    idx = torch.stack([torch.randperm(E)[:k] for _ in range(T)])
    lane_tok, dest = moe.bins(idx, E, C)
    assert bool((dest == E * C).any())
    lanes = dest.view(T, k).sort(dim=1).values
    xf = torch.randn(T, d, dtype=torch.float64, requires_grad=True)
    yw = torch.randn(E * C, d, dtype=torch.float64, requires_grad=True)
    g_in = torch.randn(E * C, d, dtype=torch.float64)
    g_out = torch.randn(T, d, dtype=torch.float64)
    got_x, = torch.autograd.grad(
        (moe._Dispatch.apply(xf, lane_tok, lanes) * g_in).sum(), xf)
    got_y, = torch.autograd.grad(
        (moe._Combine.apply(yw, lanes, lane_tok) * g_out).sum(), yw)
    zx = torch.cat([xf, xf.new_zeros(1, d)])
    want_x, = torch.autograd.grad((zx[lane_tok] * g_in).sum(), xf)
    zy = torch.cat([yw, yw.new_zeros(1, d)])
    want_y, = torch.autograd.grad(
        (zy[lanes].sum(dim=1) * g_out).sum(), yw)
    torch.testing.assert_close(got_x, want_x, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_y, want_y, rtol=1e-12, atol=1e-12)
