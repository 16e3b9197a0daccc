"""Port vs reference: configs, model blocks and the dense and ssm LMs.

The same inputs (made from a seed with numpy) and the same weights (the
reference's ``init``, carried across by ``params_from_reference``) go
through ``repro`` and ``repro_torch`` on the CPU, where the port's
``fused_norm_matmul`` takes its plain version.

Tolerances, as rtol and atol alike:
* float32, 1e-5: both sides compute in float32 from identical values (the
  reference promotes its bf16 weights to float32, the port loads them as
  float32 exactly); only the order of the sums differs (measured: 6e-7 on
  the logits, 2e-6 on the caches).
* bfloat16, 5e-2: the fused entry does not round the normalized
  activation to bf16 before the product, where the reference's
  ``rms_norm`` then einsum does; that is one bf16 ulp at the projection's
  input, carried through the layers (measured: 1e-2 on logits of
  magnitude 0.7, 4e-2 on cache values of magnitude 4, one ulp there).
  rwkv6 (family ``ssm``) holds to the same two tolerances: its bf16
  projections and token shifts round where the reference's fused
  elementwise code may not, and its float32 state carries that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import common as r_common
from repro.models import lm as r_lm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import common, lm

DENSE = ["llama3.2-1b", "llama3.2-3b", "qwen3-4b", "qwen2.5-14b"]
SSM = ["rwkv6-1.6b"]
PORTED = ("dense", "ssm")
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _pair(arch: str, dtype: str, **replace):
    """The reduced config in both packages, the reference's model and
    weights, and the port's model and the same weights."""
    rc = dataclasses.replace(r_get_config(arch, reduced=True), dtype=dtype,
                             **replace)
    tc = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype,
                             **replace)
    rm = r_lm.LM(rc)
    rp = rm.init(0)
    tm = lm.LM(tc, device="cpu")
    tp = lm.params_from_reference(
        jax.device_get(rp), device="cpu",
        dtype=torch.float32 if dtype == "float32" else None)
    return rm, rp, tm, tp


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _kv_leaves(cache):
    """The cache's stage leaves in the reference's ``jax.tree.leaves``
    order (for a dense layer: k, v; for rwkv: ffn shift, state, shift)."""
    return [t for _, t in common.sorted_leaves(cache["stages"])]


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    for reduced in (False, True):
        got = get_config(arch, reduced=reduced)
        want = r_get_config(arch, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert lm.make_program(got) == r_lm.make_program(want)


def test_param_template_matches_reference_full_llama():
    """The full llama3.2-1b tree: the reference's names, shapes and scales,
    1,235,814,400 parameters."""
    cfg, rcfg = get_config("llama3.2-1b"), r_get_config("llama3.2-1b")
    got = lm.param_template(cfg)
    want = r_lm.param_template(rcfg)
    flat_w = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in wp): w
              for wp, w in jax.tree_util.tree_flatten_with_path(
                  want, is_leaf=lambda x: isinstance(x, r_lm.Leaf))[0]}
    flat_g = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            flat_g[path] = t

    walk(got, ())
    assert flat_g.keys() == flat_w.keys()
    for path, g in flat_g.items():
        w = flat_w[path]
        assert (g.shape, g.dtype, g.scale) == (w.shape, w.dtype, w.scale)
    n = sum(int(np.prod(lf.shape)) for lf in flat_g.values())
    assert n == 1_235_814_400


def test_other_families_and_tp_raise():
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        if cfg.family in PORTED:
            with pytest.raises(NotImplementedError, match="not yet ported"):
                lm.LM(cfg, tp=2, device="cpu")
            continue
        with pytest.raises(NotImplementedError, match="not yet ported"):
            lm.LM(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="not yet ported"):
            lm.init_params(cfg, device="cpu")


# ------------------------------------------------------------------- blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_vs_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    g = rng.standard_normal(64).astype(np.float32)
    want = r_common.rms_norm(jnp.asarray(x, dtype), jnp.asarray(g, dtype))
    got = common.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(g).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # float32: 1e-6; bf16: at most one ulp of the rounded output
    _close(got, want, 1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("hd,theta", [(16, 5e5), (64, 5e5), (128, 1e6)])
def test_rope_vs_reference(hd, theta):
    np.testing.assert_array_equal(common.rope_freqs(hd, theta),
                                  r_common.rope_freqs(hd, theta))
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    want = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # angles up to 4096 rad: float32 cos/sin of the two libraries differ in
    # the last bits of the argument reduction
    _close(got, want, 1e-5)


def test_params_from_reference_round_trip():
    """bf16 weights keep their bits; float32 takes them exactly; the tree
    keeps the reference's names and layer stacking."""
    rm = r_lm.LM(r_get_config("qwen2.5-14b", reduced=True))
    ref_tree = jax.device_get(rm.init(3))
    got = lm.params_from_reference(ref_tree, device="cpu")
    got32 = lm.params_from_reference(ref_tree, device="cpu",
                                     dtype=torch.float32)
    want = jax.tree_util.tree_leaves(ref_tree)
    for leaves, dt in ((common.tree_leaves(got), torch.bfloat16),
                       (common.tree_leaves(got32), torch.float32)):
        assert len(leaves) == len(want)
        for g, w in zip(leaves, want):
            assert g.dtype == dt and tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
    assert set(got) == set(ref_tree)
    assert set(got["stages"][0][0]["mixer"]) == \
        set(ref_tree["stages"][0][0]["mixer"])
    assert common.count_params(got) == r_common.count_params(ref_tree)


def test_params_from_reference_round_trip_rwkv():
    """rwkv6's tree (the mixer's time-mix and channel-mix leaves, bf16, and
    its float32 ``w0`` and ``u``, an empty ffn dict) comes across with
    every leaf's bits, dtype and shape, under the reference's names."""
    rm = r_lm.LM(r_get_config("rwkv6-1.6b", reduced=True))
    ref_tree = jax.device_get(rm.init(4))
    got = lm.params_from_reference(ref_tree, device="cpu")
    want = jax.tree_util.tree_leaves(ref_tree)
    leaves = [t for _, t in common.sorted_leaves(got)]
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    layer = got["stages"][0][0]
    assert layer["ffn"] == {} and ref_tree["stages"][0][0]["ffn"] == {}
    assert set(layer["mixer"]) == set(ref_tree["stages"][0][0]["mixer"])
    assert layer["mixer"]["w0"].dtype == torch.float32
    assert layer["mixer"]["w_r"].dtype == torch.bfloat16
    assert common.count_params(got) == r_common.count_params(ref_tree)
    tmpl = lm.param_template(get_config("rwkv6-1.6b", reduced=True))
    assert [(p, lf.shape, lf.dtype) for p, lf in common.sorted_leaves(tmpl)] \
        == [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in common.sorted_leaves(got)]


def test_init_params_rwkv_name_rules():
    """The reference's name-dispatched rules for rwkv's leaves: ``ln_x`` and
    the norms 1, ``mu_*`` 0.5, ``w0`` -1 (float32), ``u`` N(0, 0.1)
    (float32), the matrices N(0, 1/fan_in)."""
    cfg = get_config("rwkv6-1.6b", reduced=True)
    p = lm.init_params(cfg, 2, device="cpu")
    mix = p["stages"][0][0]["mixer"]
    for name in ("ln_x", "norm"):
        assert torch.equal(mix[name], torch.ones_like(mix[name]))
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr"):
        assert torch.equal(mix[name], torch.full_like(mix[name], 0.5))
    assert mix["w0"].dtype == torch.float32
    assert torch.equal(mix["w0"], torch.full_like(mix["w0"], -1.0))
    assert mix["u"].dtype == torch.float32 and mix["u"].shape == (2, 4, 16)
    assert 0.05 < float(mix["u"].std()) < 0.2
    assert mix["w_r"].dtype == torch.bfloat16
    assert float(mix["w_r"].float().std()) == pytest.approx(1 / 8, rel=0.1)
    assert p["stages"][0][0]["ffn"] == {}


def test_init_params_seeded_on_the_template():
    cfg = get_config("qwen3-4b", reduced=True)
    a = lm.init_params(cfg, 5, device="cpu")
    b = lm.init_params(cfg, 5, device="cpu")
    c = lm.init_params(cfg, 6, device="cpu", dtype=torch.float32)
    tmpl = common.tree_leaves(lm.param_template(cfg))
    for x, y, z, lf in zip(common.tree_leaves(a), common.tree_leaves(b),
                           common.tree_leaves(c), tmpl):
        assert tuple(x.shape) == lf.shape and x.dtype == torch.bfloat16
        assert z.dtype == torch.float32
        assert torch.equal(x, y)
    mix = a["stages"][0][0]["mixer"]
    assert torch.equal(mix["norm"], torch.ones_like(mix["norm"]))
    assert torch.equal(mix["q_norm"], torch.ones_like(mix["q_norm"]))
    assert not torch.equal(common.tree_leaves(a)[0].float(),
                           common.tree_leaves(c)[0])


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + SSM)
def test_decode_step_vs_reference(arch, dtype):
    """6 decode steps of 3 rows from the reference's weights: logits,
    caches and lengths against the reference's jitted ``decode_step``."""
    rm, rp, tm, tp = _pair(arch, dtype)
    B, S = 3, 16
    rcache, tcache = rm.init_cache(B, S), tm.init_cache(B, S)
    step = jax.jit(rm.decode_step)
    rng = np.random.default_rng(1)
    for _ in range(6):
        tok = rng.integers(0, rm.cfg.vocab_size, (B, 1)).astype(np.int32)
        rl, rcache = step(rp, jnp.asarray(tok), rcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache)
        assert tl.shape == (B, rm.cfg.vocab_size)
        _close(tl, rl, TOL[dtype])
        want = jax.tree.leaves(rcache["stages"])
        assert len(_kv_leaves(tcache)) == len(want)
        for g, w in zip(_kv_leaves(tcache), want):
            # the cache's dtypes (rwkv's state is float32 in both)
            assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name
            _close(g, w, TOL[dtype])
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(rcache["length"]))


def test_rwkv_bf16_first_decode_step_is_bit_exact():
    """rwkv6 in bf16, one decode step from an empty cache: logits and every
    cache leaf equal the reference's jitted step bit for bit.  That holds
    because the port computes as XLA compiles the reference's layer: the
    residual sum reaches the channel mix's norm unrounded, and sigmoid is
    ``1 / (1 + exp(-x))`` op by op."""
    rm, rp, tm, tp = _pair("rwkv6-1.6b", "bfloat16")
    B = 3
    tok = np.random.default_rng(1).integers(
        0, rm.cfg.vocab_size, (B, 1)).astype(np.int32)
    rl, rcache = jax.jit(rm.decode_step)(rp, jnp.asarray(tok),
                                         rm.init_cache(B, 16))
    tl, tcache = tm.decode_step(tp, torch.from_numpy(tok),
                                tm.init_cache(B, 16))
    np.testing.assert_array_equal(tl.float().numpy(),
                                  np.asarray(rl, np.float32))
    for g, w in zip(_kv_leaves(tcache), jax.tree.leaves(rcache["stages"])):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_sliding_window_rolling_decode_vs_reference():
    """The window path of ``gqa_apply``: a rolling cache of 4 slots under a
    window of 4, 7 steps, so slots wrap."""
    rm, rp, tm, tp = _pair("llama3.2-1b", "float32", attn_kind="swa",
                           window=4)
    B, S = 2, 4
    rcache, tcache = rm.init_cache(B, S), tm.init_cache(B, S)
    step = jax.jit(rm.decode_step)
    rng = np.random.default_rng(2)
    for _ in range(7):
        tok = rng.integers(0, rm.cfg.vocab_size, (B, 1)).astype(np.int32)
        rl, rcache = step(rp, jnp.asarray(tok), rcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache)
        _close(tl, rl, TOL["float32"])
    for g, w in zip(_kv_leaves(tcache), jax.tree.leaves(rcache["stages"])):
        _close(g, w, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-14b"] + SSM)
def test_prefill_vs_reference(arch, dtype):
    rm, rp, tm, tp = _pair(arch, dtype)
    rng = np.random.default_rng(3)
    # rwkv's chunked form takes whole chunks of 16 tokens (two here)
    S = 32 if arch in SSM else 24
    toks = rng.integers(0, rm.cfg.vocab_size, (2, S)).astype(np.int32)
    want = rm.prefill(rp, {"tokens": jnp.asarray(toks)})
    got = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, rm.cfg.vocab_size)
    _close(got, want, TOL[dtype])


def test_swiglu_vs_reference():
    rng = np.random.default_rng(5)
    x, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) / 4
                     for s in ((5, 32), (32, 48), (32, 48), (48, 32)))
    want = r_common.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    got = common.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    _close(got, want, 1e-5)


def test_flash_attention_chunks_vs_reference():
    """Ragged chunks (Sq=20, Sk=20 over chunks of 8) against the
    reference's padded double-blocked version, causal and windowed, on
    GQA keys and values repeated by ``repeat_kv`` (2 KV heads, 4 query)."""
    from repro.models import attention as r_att
    from repro_torch.models import attention as att
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 20, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
            for _ in range(2))
    jk, jv = (r_att.repeat_kv(jnp.asarray(a), 4) for a in (k, v))
    tk, tv = (att.repeat_kv(torch.from_numpy(a), 4) for a in (k, v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for window in (None, 5):
        want = r_att.flash_attention(jnp.asarray(q), jk, jv, window=window,
                                     q_chunk=8, kv_chunk=8)
        got = att.flash_attention(torch.from_numpy(q), tk, tv,
                                  window=window, q_chunk=8, kv_chunk=8)
        _close(got, want, 1e-5)


def test_teacher_forced_decode_matches_prefill():
    """The port's token-by-token decode ends at its own prefill's logits
    (as ``test_arch_smoke.py::test_decode_matches_train_forward``)."""
    _, _, tm, tp = _pair("llama3.2-1b", "float32")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(
        rng.integers(0, tm.cfg.vocab_size, (1, 16)).astype(np.int32))
    full = tm.prefill(tp, {"tokens": toks})
    cache = tm.init_cache(1, 16)
    for t in range(16):
        logits, cache = tm.decode_step(tp, toks[:, t:t + 1], cache)
    torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)
