"""The port's mamba block (``repro_torch.models.mamba``) against the
reference's ``repro.models.mamba`` on the CPU.

The same weights and inputs, made from a seed with numpy, go through both
packages at the reduced jamba-v0.1-52b's widths (d 64, d_inner 128,
d_state 8, d_conv 4, dt_rank 4).  The port takes the un-normalized rows
and the mixer's RMSNorm gamma (its ``w_in`` is a fused entry); the
reference takes ``rms_norm(x, gamma)``.

* The scan equals ``jax.lax.associative_scan`` bit for bit in float32, at
  lengths that are and are not powers of two: the port pairs neighbours
  and recurses as the reference's does, so it forms the same products in
  the same order.
* float32, 1e-5 (rtol and atol): ``_ssm_scan`` and the three modes of
  ``mamba_apply`` (measured: 1e-6 on outputs of order 1); the gradients
  of the train mode against ``jax.grad``, 1e-4 of each gradient's largest
  value, as ``tests/test_torch_train.py``.
* bf16: with the entry given the reference's rounding (``rms_norm`` to
  bf16, then the product), a decode step's output equals the jitted
  reference's bit for bit, and so does a prefill's: the conv's products
  and sums round op by op, the sigmoid is ``1 / (1 + exp(-x))`` op by op,
  and the compiled reference reads three values unrounded (the conv's
  silu into the scan and into decode's ``D * x``, decode's ``w_dt``
  product into ``+ dt_bias``).  The float32 state and ``dt`` differ in
  their last bits (``log1p`` and ``exp`` of the two libraries): 1e-6.
  The eager reference rounds every bf16 value; the port follows the
  compiled one, which ``tests/test_torch_models.py`` runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import common as r_common
from repro.models import mamba as r_mam
from repro_torch.configs import get_config
from repro_torch.models import common
from repro_torch.models import mamba as mam

ARCH = "jamba-v0.1-52b"
F32_LEAVES = ("A_log", "D", "dt_bias")


def _cfgs(dtype="float32"):
    return (dataclasses.replace(r_get_config(ARCH, reduced=True),
                                dtype=dtype),
            dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype))


def _weights(cfg, seed=0):
    """Seeded weights in the reference's init rules (``A_log`` log(1..N),
    ``D`` ones) but a random ``dt_bias`` and ``conv_b``, so that both
    terms count."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in mam.mamba_params_shape(cfg).items():
        if k == "A_log":
            a = np.log(np.broadcast_to(np.arange(1, s[-1] + 1), s))
        elif k == "D":
            a = np.ones(s)
        elif len(s) == 1:
            a = rng.standard_normal(s) * 0.3
        else:
            a = rng.standard_normal(s) / np.sqrt(s[-2])
        out[k] = a.astype(np.float32)
    return out


def _trees(p, dtype):
    """``p`` in both packages: the float32 leaves stay float32, the rest in
    ``dtype``."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jnp.float32 if k in F32_LEAVES else jd)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k in F32_LEAVES
                                    else td) for k, v in p.items()}
    return jp, tp


def _inputs(cfg, B, S, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    jx, jg = jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(
        g, getattr(jnp, dtype))
    tx, tg = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, g))
    return r_common.rms_norm(jx, jg), tx, tg


def _cache(cfg, B, seed=2):
    di = cfg.mamba.expand * cfg.d_model
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, di, cfg.mamba.d_state)).astype(
        np.float32), rng.standard_normal((B, cfg.mamba.d_conv - 1, di)
                                         ).astype(np.float32))


def _flat(out, mode):
    return (out,) if mode == "train" else (out[0], *out[1])


def _f32(a):
    return np.asarray(a.float().detach() if isinstance(a, torch.Tensor)
                      else a, np.float32)


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 13, 16, 37])
def test_scan_equals_associative_scan(S):
    rng = np.random.default_rng(S)
    a = np.exp(-rng.random((2, S, 3, 4))).astype(np.float32)
    b = rng.standard_normal((2, S, 3, 4)).astype(np.float32)
    wa, wb = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ga, gb = mam._scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


@pytest.mark.parametrize("S", [13, 16])
def test_ssm_scan_vs_reference(S):
    rng = np.random.default_rng(3)
    B, di, N = 2, 12, 5
    x, dt = (rng.standard_normal((B, S, di)).astype(np.float32),
             np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(
                 np.float32))
    A = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal(di).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D)
    want = r_mam._ssm_scan(*(jnp.asarray(a) for a in args))
    got = mam._ssm_scan(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_apply_vs_reference(mode):
    """float32, the three modes; prefill at 13 tokens (not a power of two),
    decode from a seeded state and conv tail."""
    rc, tc = _cfgs()
    jp, tp = _trees(_weights(tc), "float32")
    B, S = 2, (1 if mode == "decode" else 13)
    h, tx, tg = _inputs(tc, B, S, "float32")
    cache = _cache(tc, B) if mode == "decode" else None
    want = r_mam.mamba_apply(
        jp, h, rc, mode=mode,
        cache=None if cache is None else tuple(map(jnp.asarray, cache)))
    got = mam.mamba_apply(
        tp, tx, tc, gamma=tg, mode=mode,
        cache=None if cache is None else tuple(map(torch.from_numpy, cache)))
    for g, w in zip(_flat(got, mode), _flat(want, mode)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-5, atol=1e-5)


def test_mamba_train_grads_vs_reference():
    """float32: the gradients of a sum of the train mode's output through
    the scan, of every weight and of x, against ``jax.grad``."""
    rc, tc = _cfgs()
    p = _weights(tc)
    jp, tp = _trees(p, "float32")
    _, tx, tg = _inputs(tc, 2, 11, "float32")
    wgt = np.random.default_rng(4).standard_normal(
        (2, 11, tc.d_model)).astype(np.float32)

    def r_loss(jp, x, g):
        h = r_common.rms_norm(x, g)
        return jnp.sum(r_mam.mamba_apply(jp, h, rc, mode="train") * wgt)

    want = jax.grad(r_loss, argnums=(0, 1, 2))(
        jp, jnp.asarray(tx.numpy()), jnp.asarray(tg.numpy()))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    x, g = tx.clone().requires_grad_(True), tg.clone().requires_grad_(True)
    loss = (mam.mamba_apply(leaves, x, tc, gamma=g, mode="train")
            * torch.from_numpy(wgt)).sum()
    loss.backward()
    pairs = [(leaves[k].grad, want[0][k], k) for k in p]
    pairs += [(x.grad, want[1], "x"), (g.grad, want[2], "gamma")]
    for got, w, name in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def _entry_as_reference(monkeypatch):
    """The fused entry given the reference's rounding: ``rms_norm`` in the
    model's dtype, then the product."""
    monkeypatch.setattr(mam.ops, "fused_norm_matmul",
                        lambda x, g, w: common.rms_norm(x, g) @ w)


def test_mamba_bf16_decode_step_equals_jitted_reference(monkeypatch):
    _entry_as_reference(monkeypatch)
    rc, tc = _cfgs("bfloat16")
    jp, tp = _trees(_weights(tc), "bfloat16")
    B = 3
    h, tx, tg = _inputs(tc, B, 1, "bfloat16")
    h0, tail = _cache(tc, B)
    jcache = (jnp.asarray(h0), jnp.asarray(tail, jnp.bfloat16))
    tcache = (torch.from_numpy(h0), torch.from_numpy(tail).to(torch.bfloat16))
    want = jax.jit(lambda p, h, c: r_mam.mamba_apply(
        p, h, rc, mode="decode", cache=c))(jp, h, jcache)
    got = mam.mamba_apply(tp, tx, tc, gamma=tg, mode="decode", cache=tcache)
    out, (state, new_tail) = got
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert new_tail.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(out), _f32(want[0]))
    np.testing.assert_array_equal(_f32(new_tail), _f32(want[1][1]))
    np.testing.assert_allclose(_f32(state), _f32(want[1][0]), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mamba_bf16_full_sequence_equals_jitted_reference(mode, monkeypatch):
    _entry_as_reference(monkeypatch)
    rc, tc = _cfgs("bfloat16")
    jp, tp = _trees(_weights(tc), "bfloat16")
    h, tx, tg = _inputs(tc, 2, 13, "bfloat16")
    want = _flat(jax.jit(lambda p, h: r_mam.mamba_apply(
        p, h, rc, mode=mode))(jp, h), mode)
    got = _flat(mam.mamba_apply(tp, tx, tc, gamma=tg, mode=mode), mode)
    np.testing.assert_array_equal(_f32(got[0]), _f32(want[0]))
    if mode == "prefill":
        np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(_f32(got[2]), _f32(want[2]))


def test_init_cache_and_dt_rank_vs_reference():
    rc, tc = _cfgs("bfloat16")
    for g, w in zip(mam.mamba_init_cache(tc, 3, torch.bfloat16),
                    r_mam.mamba_init_cache(rc, 3, jnp.bfloat16)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name
        assert not g.any()
    for d in (1, 16, 17, 64, 4096):
        assert mam.default_dt_rank(d) == r_mam.default_dt_rank(d)
    assert mam.mamba_params_shape(tc) == r_mam.mamba_params_shape(rc)
