"""Port vs reference: configs, model blocks and the LMs of all six
families: dense, ssm, vlm and moe (llava-next-mistral-7b, mixtral-8x22b,
deepseek-v3-671b with MLA and the MTP block), hybrid (jamba-v0.1-52b:
mamba, attention and MoE) and encdec (whisper-large-v3: the encoder and
the cross-attention).

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
  elementwise code may not, and its float32 state carries that.  So do
  the vlm and moe families: the router reads the same ``rms_norm`` output
  in float32, so a layer's experts are the reference's unless a score is
  within a rounding of a tie, and MLA's absorbed decode is float32 in
  both.  Their training losses and gradients take
  ``tests/test_torch_train.py``'s tolerances (float32 1e-5 and 1e-4).
  whisper holds to them too.  jamba holds to them in float32.  In bf16
  its reduced config is ruled by rounding in both packages: the
  reference's own bf16 run lies up to 0.29 from its float32 run on the
  prefill logits, and 37% of the largest embedding gradient away.  Two
  things make it so: the bf16 mamba layers magnify one rounding into
  several, and a router's top 2 of 4 experts then flips where two scores
  lie close (a flip decides the comparison).  So jamba's bf16 cases run
  both packages on the reference's routing (``_routed_as_reference``;
  the float32 cases route on their own and hold the picks exactly) and
  hold each quantity to the reference's own error
  (``_check_bf16_budget``): the port's RMS
  distance from the reference's float32 result on the same weights is at
  most BF16_BUDGET times the reference's bf16 one, or under 5e-2
  (measured: at most 1.65x on a decode cache leaf, 1.17x on the prefill
  logits, 1.61x on a gradient whose RMS distance passes 5e-2; the loss
  lies 0.0038 from the float32 reference's).
"""

import contextlib
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
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import common, lm
from repro_torch.train import step as t_step

DENSE = ["llama3.2-1b", "llama3.2-3b", "qwen3-4b", "qwen2.5-14b"]
SSM = ["rwkv6-1.6b"]
NEW = ["llava-next-mistral-7b", "mixtral-8x22b", "deepseek-v3-671b",
       "jamba-v0.1-52b", "whisper-large-v3"]
PORTED = ("dense", "ssm", "vlm", "moe", "hybrid", "encdec")
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# families whose bf16 results are held to the reference's own bf16 error
BF16_BY_BUDGET = ("hybrid",)
BF16_BUDGET = 2.0


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


def _prefill_batch(cfg, toks, rng):
    """The prefill inputs in both packages: tokens, vlm's seeded patch
    embeddings and encdec's seeded frame embeddings."""
    r, t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    for name, n in (("patches", cfg.vision_tokens),
                    ("frames", cfg.encoder_seq if cfg.is_encdec else 0)):
        if n:
            a = rng.standard_normal(
                (toks.shape[0], n, cfg.d_model)).astype(np.float32)
            r[name], t[name] = jnp.asarray(a), torch.from_numpy(a)
    return r, t


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _by_budget(cfg, dtype: str) -> bool:
    return dtype == "bfloat16" and cfg.family in BF16_BY_BUDGET


def _rms(a, b) -> float:
    d = np.asarray(a, np.float32) - np.asarray(b, np.float32)
    return float(np.sqrt(np.mean(d * d)))


def _check_bf16_budget(got, want, truth, what: str) -> None:
    """The port's bf16 values ``got`` against the reference's bf16 values
    ``want`` and its float32 values ``truth`` (one quantity): the port's
    RMS distance from ``truth`` is at most BF16_BUDGET times the
    reference's, or under 5e-2."""
    got, want, truth = (np.asarray(x, np.float32) for x in (got, want,
                                                             truth))
    assert np.isfinite(got).all(), what
    err, ref_err = _rms(got, truth), _rms(want, truth)
    assert err <= max(BF16_BUDGET * ref_err, TOL["bfloat16"]), (
        f"{what}: the port's bf16 lies {err} (RMS) from the float32 "
        f"reference, the reference's bf16 {ref_err}")


def _router_key(router) -> float:
    """A layer's router weights as a number both packages compute alike."""
    return float(np.asarray(router, np.float32).astype(np.float64).sum())


@contextlib.contextmanager
def _routed_as_reference(monkeypatch):
    """Both packages' ``router_probs`` patched: the reference's records
    its weights and picks by layer (its router weights' key), and the
    port's returns them in place of its own (with its own scores, which
    the aux loss reads), so that both route alike."""
    from repro.models import moe as r_moe
    from repro_torch.models import moe as t_moe
    ref = {}
    r_probs, t_probs = r_moe.router_probs, t_moe.router_probs

    def record(key, w, idx, scores):
        ref.setdefault(key, []).append(
            (np.asarray(w), np.asarray(idx), np.asarray(scores)))

    def ref_router(p, x, cfg):
        w, idx, scores = r_probs(p, x, cfg)
        jax.debug.callback(lambda r, *a: record(_router_key(r), *a),
                           p["router"], w, idx, scores)
        return w, idx, scores

    def port_router(p, x, cfg):
        w, idx, scores = t_probs(p, x, cfg)
        rw, ridx, _ = ref[_router_key(p["router"].detach().float())][-1]
        return (torch.from_numpy(rw.copy()).reshape(w.shape).to(w.dtype),
                torch.from_numpy(ridx.copy()).reshape(idx.shape).to(
                    idx.dtype), scores)

    monkeypatch.setattr(r_moe, "router_probs", ref_router)
    monkeypatch.setattr(t_moe, "router_probs", port_router)
    yield ref


def _reference32(rm, rp):
    """The reference's model in float32 on the same weights."""
    rm32 = r_lm.LM(dataclasses.replace(rm.cfg, dtype="float32"))
    return rm32, jax.tree.map(lambda a: a.astype(jnp.float32), rp)


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


@pytest.mark.parametrize("arch", NEW)
def test_param_template_matches_reference_full_new_families(arch):
    """The full llava, mixtral, deepseek, jamba and whisper trees (the MoE
    banks, MLA's leaves, the MTP block, ``vision_proj``, mamba's leaves
    with their float32 ``A_log``, ``D`` and ``dt_bias``, the cross
    projections, the encoder stack, ``enc_final_norm`` and
    ``frame_proj``): the reference's names, shapes, dtypes and scales, and
    its parameter count."""
    got = common.sorted_leaves(lm.param_template(get_config(arch)))
    want = jax.tree_util.tree_flatten_with_path(
        r_lm.param_template(r_get_config(arch)),
        is_leaf=lambda x: isinstance(x, r_lm.Leaf))[0]
    assert [p for p, _ in got] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in wp)
        for wp, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert (g.shape, g.dtype, g.scale) == (w.shape, w.dtype, w.scale)
    n = sum(int(np.prod(g.shape)) for _, g in got)
    assert n == sum(int(np.prod(w.shape)) for _, w in want)


def test_other_families_and_tp_raise():
    """Every family is ported, and every one builds at tp = 2 (``LM`` and
    ``init_params`` alike, with its shards' specs); so do the two sequence
    splits of the cache: ``cache_seq_shard`` at tp = 2 (its gqa cache
    split over ``model`` on the sequence, with no head axis), and a
    batch-1 cache over a data axis above 1 (split over ``data`` on the
    sequence, ``length`` replicated)."""
    assert set(lm._PORTED_FAMILIES) == set(PORTED)
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        assert cfg.family in PORTED
        assert lm.LM(cfg, tp=2, device="cpu").tp == 2
        params = lm.init_params(cfg, device="cpu", tp=2)
        assert [t.shape for _, t in common.sorted_leaves(params)] == [
            lf.shape for _, lf in common.sorted_leaves(
                lm.param_template(cfg, 2))]
    llama = get_config("llama3.2-1b", reduced=True)
    seq = dataclasses.replace(llama, cache_seq_shard=True)
    assert lm.LM(seq, tp=2, device="cpu").tp == 2
    assert [t.shape for _, t in common.sorted_leaves(
        lm.init_params(seq, device="cpu", tp=2))] == [
            lf.shape for _, lf in common.sorted_leaves(
                lm.param_template(seq, 2))]
    split = mesh_mod.Mesh(("data", "model"), {"data": 1, "model": 2}, 1,
                          torch.device("cpu"), {}, "gloo", "send_recv")
    kv = lm.LM(seq, mesh=split, device="cpu").init_cache(4, 16)[
        "stages"][0][0]["mixer"]["k"]
    assert kv.shape == (llama.num_layers, 4, 8, llama.num_kv_heads,
                        llama.head_dim)
    data = mesh_mod.Mesh(("data", "model"), {"data": 2, "model": 1}, 0,
                         torch.device("cpu"), {}, "gloo", "send_recv")
    long = lm.LM(llama, mesh=data, device="cpu")
    tmpl = long.cache_template(1, 16)
    assert tmpl["stages"][0][0]["mixer"]["k"].spec == common.Spec(
        None, None, "data", None, None)
    cache = long.init_cache(1, 16)
    assert cache["length"].shape == (1,)
    assert cache["stages"][0][0]["mixer"]["v"].shape[1:3] == (1, 8)


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


@pytest.mark.parametrize("arch", NEW)
def test_params_from_reference_round_trip_new_families(arch):
    """The reference's llava, mixtral and deepseek trees, the
    layer-stacked (L, E, d, f) expert banks included, come across with
    every leaf's bits, dtype and shape, under the reference's names."""
    ref_tree = jax.device_get(r_lm.LM(r_get_config(arch, reduced=True))
                              .init(4))
    got = lm.params_from_reference(ref_tree, device="cpu")
    want = jax.tree_util.tree_leaves(ref_tree)
    leaves = common.sorted_leaves(got)
    assert len(leaves) == len(want)
    for (_, g), w in zip(leaves, want):
        assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    tmpl = lm.param_template(get_config(arch, reduced=True))
    assert [(p, lf.shape) for p, lf in common.sorted_leaves(tmpl)] == \
        [(p, tuple(t.shape)) for p, t in leaves]
    assert common.count_params(got) == r_common.count_params(ref_tree)


def test_init_params_new_leaves_name_rules(monkeypatch):
    """The reference's rules on the new leaves: MLA's two norms and the
    MoE ffn's norm 1, every matrix N(0, 1/fan_in) with fan_in =
    shape[-2] (an expert bank's is d, ``w_down``'s is d_ff_expert, the MTP
    ``proj``'s 2 d), and a bank drawn in slices when it is larger than one
    draw: seeded, and the same statistics."""
    cfg = get_config("deepseek-v3-671b", reduced=True)
    p = lm.init_params(cfg, 3, device="cpu", dtype=torch.float32)
    mix, ffn = p["stages"][1][0]["mixer"], p["stages"][1][0]["ffn"]
    for t in (mix["q_a_norm"], mix["kv_a_norm"], ffn["norm"]):
        assert torch.equal(t, torch.ones_like(t))
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    for t, fan_in in ((ffn["router"], d), (ffn["w_gate"], d),
                      (ffn["w_down"], f), (ffn["s_up"], d),
                      (mix["wq_b"], cfg.mla.q_lora_rank),
                      (p["mtp"]["proj"], 2 * d)):
        assert float(t.std()) == pytest.approx(fan_in ** -0.5, rel=0.15)
    vis = lm.init_params(get_config("llava-next-mistral-7b", reduced=True),
                         0, device="cpu")["vision_proj"]
    assert vis.dtype == torch.bfloat16 and vis.shape == (64, 64)
    monkeypatch.setattr(common, "DRAW_ELEMS", 64)  # slices of one row
    gen = torch.Generator().manual_seed(1)
    a = common.normal_init(gen, (3, 50, 40), 0.5, torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    b = common.normal_init(gen, (3, 50, 40), 0.5, torch.bfloat16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert float(a.float().std()) == pytest.approx(0.5, rel=0.05)
    assert float(a.float().mean()) == pytest.approx(0.0, abs=0.02)


def test_init_params_mamba_and_encdec_name_rules():
    """The reference's rules on jamba's and whisper's leaves: ``dt_bias``
    and ``conv_b`` 0, ``A_log`` log(1..N) on every channel, ``D`` 1 (the
    three float32), the cross and encoder norms 1, the matrices
    N(0, 1/fan_in); the template's dtypes follow the model's."""
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    p = lm.init_params(cfg, 1, device="cpu")
    mix = p["stages"][0][0]["mixer"]
    N = cfg.mamba.d_state
    for name in ("dt_bias", "conv_b"):
        assert not mix[name].any()
    want = torch.log(torch.arange(1, N + 1, dtype=torch.float32))
    assert torch.equal(mix["A_log"], want.expand_as(mix["A_log"]))
    assert torch.equal(mix["D"], torch.ones_like(mix["D"]))
    for name in ("A_log", "D", "dt_bias"):
        assert mix[name].dtype == torch.float32
    assert mix["w_in"].dtype == torch.bfloat16
    assert float(mix["w_bcdt"].float().std()) == pytest.approx(
        (2 * cfg.d_model) ** -0.5, rel=0.15)
    tmpl = lm.param_template(dataclasses.replace(cfg, dtype="float32"))
    assert tmpl["stages"][0][0]["mixer"]["w_in"].dtype == "float32"
    w = lm.init_params(get_config("whisper-large-v3", reduced=True), 1,
                       device="cpu")
    for t in (w["enc_final_norm"], w["encoder"]["mixer"]["norm"],
              w["stages"][0][0]["mixer"]["norm_cross"]):
        assert torch.equal(t, torch.ones_like(t))
    assert w["encoder"]["mixer"]["wq"].shape == (2, 64, 4, 16)
    assert float(w["frame_proj"].float().std()) == pytest.approx(
        64 ** -0.5, rel=0.15)


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
@pytest.mark.parametrize("arch", DENSE + SSM + NEW)
def test_decode_step_vs_reference(arch, dtype, monkeypatch):
    """6 decode steps of 3 rows from the reference's weights: logits,
    caches (MLA's latent and rope caches, mamba's state and conv tail too)
    and lengths against the reference's jitted ``decode_step`` (whisper's
    with the zero encoder stub in both; jamba's bf16 by the budget)."""
    rm, rp, tm, tp = _pair(arch, dtype)
    budget = _by_budget(tm.cfg, dtype)
    B, S = 3, 16
    rcache, tcache = rm.init_cache(B, S), tm.init_cache(B, S)
    step = jax.jit(rm.decode_step)
    stack = contextlib.ExitStack()
    if budget:
        stack.enter_context(_routed_as_reference(monkeypatch))
        rm32, rp32 = _reference32(rm, rp)
        cache32, step32 = rm32.init_cache(B, S), jax.jit(rm32.decode_step)
        logits = ([], [], [])
    rng = np.random.default_rng(1)
    for _ in range(6):
        tok = rng.integers(0, rm.cfg.vocab_size, (B, 1)).astype(np.int32)
        rl, rcache = step(rp, jnp.asarray(tok), rcache)
        jax.effects_barrier()
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache)
        assert tl.shape == (B, rm.cfg.vocab_size)
        want = jax.tree.leaves(rcache["stages"])
        assert len(_kv_leaves(tcache)) == len(want)
        for g, w in zip(_kv_leaves(tcache), want):
            # the cache's dtypes (rwkv's and mamba's states are float32)
            assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(rcache["length"]))
        if budget:
            l32, cache32 = step32(rp32, jnp.asarray(tok), cache32)
            jax.effects_barrier()
            for part, x in zip(logits, (tl.float(), rl, l32)):
                part.append(np.asarray(x, np.float32))
            continue
        _close(tl, rl, TOL[dtype])
        for g, w in zip(_kv_leaves(tcache), want):
            _close(g, w, TOL[dtype])
    stack.close()
    if budget:
        _check_bf16_budget(*logits, "logits")
        for i, (g, w, t) in enumerate(zip(
                _kv_leaves(tcache), jax.tree.leaves(rcache["stages"]),
                jax.tree.leaves(cache32["stages"]))):
            _check_bf16_budget(g.float(), w, t, f"cache leaf {i}")


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
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-14b"] + SSM + NEW)
def test_prefill_vs_reference(arch, dtype, monkeypatch):
    """The last position's logits of a full forward; llava's prompt sits
    behind its projected patch embeddings, whisper's decoder reads the
    encoder's output of seeded frames (jamba's bf16 by the budget)."""
    rm, rp, tm, tp = _pair(arch, dtype)
    rng = np.random.default_rng(3)
    # rwkv's chunked form takes whole chunks of 16 tokens (two here)
    S = 32 if arch in SSM else 24
    toks = rng.integers(0, rm.cfg.vocab_size, (2, S)).astype(np.int32)
    r_batch, t_batch = _prefill_batch(tm.cfg, toks, rng)
    if _by_budget(tm.cfg, dtype):
        rm32, rp32 = _reference32(rm, rp)
        with _routed_as_reference(monkeypatch):
            want = rm.prefill(rp, r_batch)
            jax.effects_barrier()
            got = tm.prefill(tp, t_batch)
        _check_bf16_budget(got.float(), want, rm32.prefill(rp32, r_batch),
                           "prefill logits")
        return
    want = rm.prefill(rp, r_batch)
    got = tm.prefill(tp, t_batch)
    assert got.shape == (2, rm.cfg.vocab_size)
    _close(got, want, TOL[dtype])


def test_whisper_decode_step_with_encoder_output_vs_reference():
    """whisper's decode given the encoder's output of seeded frames (not
    the zero stub) against the reference's jitted ``decode_step``, 4 steps,
    float32: logits and caches."""
    rm, rp, tm, tp = _pair("whisper-large-v3", "float32")
    B, S = 2, 8
    rng = np.random.default_rng(9)
    fr = rng.standard_normal((B, tm.cfg.encoder_seq, tm.cfg.d_model)
                             ).astype(np.float32)
    r_enc = rm._encode(rp, jnp.asarray(fr))
    t_enc = tm._encode(tp, torch.from_numpy(fr))
    _close(t_enc, r_enc, TOL["float32"])
    step = jax.jit(lambda p, t, c, e: rm.decode_step(p, t, c, enc_out=e))
    rcache, tcache = rm.init_cache(B, S), tm.init_cache(B, S)
    for _ in range(4):
        tok = rng.integers(0, tm.cfg.vocab_size, (B, 1)).astype(np.int32)
        rl, rcache = step(rp, jnp.asarray(tok), rcache, r_enc)
        before = tcache
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), tcache,
                                    enc_out=t_enc)
        _close(tl, rl, TOL["float32"])
    # the same last step on the zero stub reads another input
    zl, _ = tm.decode_step(tp, torch.from_numpy(tok), before)
    assert not torch.allclose(zl, tl)
    for g, w in zip(_kv_leaves(tcache), jax.tree.leaves(rcache["stages"])):
        _close(g, w, TOL["float32"])


def test_swiglu_vs_reference():
    rng = np.random.default_rng(5)
    x, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) / 4
                     for s in ((5, 32), (32, 48), (32, 48), (48, 32)))
    want = r_common.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    got = common.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    _close(got, want, 1e-5)


def test_flash_attention_noncausal_ragged_vs_reference():
    """whisper's encoder and cross-attention shape: non-causal, Sk = 1500
    frames over 512-chunks (a ragged last chunk of 476), Sq 1500 and 1."""
    from repro.models import attention as r_att
    from repro_torch.models import attention as att
    rng = np.random.default_rng(6)
    k, v = (rng.standard_normal((1, 1500, 2, 16)).astype(np.float32)
            for _ in range(2))
    for sq in (1500, 1):
        q = rng.standard_normal((1, sq, 2, 16)).astype(np.float32)
        want = r_att.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=False)
        got = att.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=False)
        assert tuple(got.shape) == want.shape
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


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b"])
def test_teacher_forced_decode_matches_prefill_moe(arch):
    """The MoE families' token-by-token decode (MLA's absorbed form for
    deepseek; jamba's mamba state and conv tail against its scan) ends at
    their prefill's logits, at capacity factor 16 so that no pick drops
    (``tests/test_arch_smoke.py:72-74``)."""
    cfg = get_config(arch, reduced=True)
    _, _, tm, tp = _pair(arch, "float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(
        rng.integers(0, tm.cfg.vocab_size, (1, 16)).astype(np.int32))
    full = tm.prefill(tp, {"tokens": toks})
    cache = tm.init_cache(1, 16)
    for t in range(16):
        logits, cache = tm.decode_step(tp, toks[:, t:t + 1], cache)
    torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW)
def test_train_loss_and_grads_vs_reference_new_families(arch, dtype,
                                                        monkeypatch):
    """``train_loss`` (llava's text positions behind its patches; the MoE
    aux loss; deepseek's MTP term; whisper's encoder over seeded frames;
    jamba's scan) and every leaf's gradient against ``jax.value_and_grad``
    of the reference's, with remat: the loss and the ``ce`` and ``aux``
    metrics, then the gradients (float32 1e-5 and 1e-4, bf16 5e-2; jamba's
    bf16 by the budget)."""
    rm, rp, tm, tp = _pair(arch, dtype)
    budget = _by_budget(tm.cfg, dtype)
    if budget:
        rm32, rp32 = _reference32(rm, rp)
    if dtype == "float32":  # weights and gradients in float32
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
        tp = common.tree_map(lambda t: t.float(), tp)
    rng = np.random.default_rng(11)
    toks, labels = (rng.integers(0, tm.cfg.vocab_size, (2, 16)).astype(
        np.int32) for _ in range(2))
    r_batch, t_batch = _prefill_batch(tm.cfg, toks, rng)
    r_batch["labels"] = jnp.asarray(labels)
    t_batch["labels"] = torch.from_numpy(labels)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: rm.train_loss(p, b, remat=True), has_aux=True))
    if budget:
        with _routed_as_reference(monkeypatch):
            (r_loss, r_met), r_grads = vg(rp, r_batch)
            jax.effects_barrier()
            loss, grads = t_step.value_and_grad(t_step.make_loss_fn(tm), tp,
                                                t_batch)
            _, t_met = tm.train_loss(tp, t_batch)
        (l32, m32), g32 = jax.jit(jax.value_and_grad(
            lambda p, b: rm32.train_loss(p, b, remat=True),
            has_aux=True))(rp32, r_batch)
        for got, want, truth, what in (
                (loss, r_loss, l32, "loss"), (t_met["aux"], r_met["aux"],
                                              m32["aux"], "aux")):
            _check_bf16_budget(float(got), want, truth, what)
        r_leaves, t32 = jax.tree.leaves(r_grads), jax.tree.leaves(g32)
        t_leaves = common.sorted_leaves(grads)
        assert len(r_leaves) == len(t_leaves) == len(t32)
        for (path, t), r, r32 in zip(t_leaves, r_leaves, t32):
            _check_bf16_budget(t.float(), r, r32, str(path))
        return
    (r_loss, r_met), r_grads = vg(rp, r_batch)
    loss, grads = t_step.value_and_grad(t_step.make_loss_fn(tm), tp,
                                        t_batch)
    _, t_met = tm.train_loss(tp, t_batch)
    loss_tol, grad_tol = (1e-5, 1e-4) if dtype == "float32" else (5e-2,
                                                                    5e-2)
    for got, want in ((loss, r_loss), (t_met["ce"], r_met["ce"]),
                      (t_met["aux"], r_met["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=loss_tol,
                                   atol=loss_tol)
    assert (float(t_met["aux"]) > 0) == (tm.cfg.moe is not None)
    r_leaves = jax.tree.leaves(r_grads)
    t_leaves = common.sorted_leaves(grads)
    assert len(r_leaves) == len(t_leaves)
    for (path, t), r in zip(t_leaves, r_leaves):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(r, np.float32), rtol=grad_tol,
                                   atol=grad_tol, err_msg=str(path))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_apply_full_sequence_modes_vs_reference(mode):
    """MLA's train and prefill forms (the prefill's latent cache rows, c_kv
    and the rope key, too) against the reference's ``mla_apply`` of the
    normalized rows, float32; the port takes the un-normalized rows and
    the mixer's gamma."""
    from repro.models import attention as r_att
    from repro_torch.models import attention as att
    rc = dataclasses.replace(r_get_config("deepseek-v3-671b", reduced=True),
                             dtype="float32")
    tc = dataclasses.replace(get_config("deepseek-v3-671b", reduced=True),
                             dtype="float32")
    rng = np.random.default_rng(12)
    p = {k: (rng.standard_normal(s) / (np.sqrt(s[-2]) if len(s) > 1 else 1)
             ).astype(np.float32) for k, s in att.mla_params_shape(tc).items()}
    x = rng.standard_normal((2, 10, tc.d_model)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(tc.d_model)).astype(np.float32)
    pos = np.arange(10)[None]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    h = r_common.rms_norm(jnp.asarray(x), jnp.asarray(gamma))
    want = r_att.mla_apply(jp, h, rc, positions=jnp.asarray(pos), mode=mode)
    got = att.mla_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), tc,
                        gamma=torch.from_numpy(gamma),
                        positions=torch.from_numpy(pos), mode=mode)
    if mode == "train":
        got, want = (got,), (want,)
    else:
        got, want = (got[0], *got[1]), (want[0], *want[1])
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, TOL["float32"])
