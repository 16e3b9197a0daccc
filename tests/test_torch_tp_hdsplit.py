"""The gqa decode cache split over ``head_dim`` against ``repro``'s ``LM(cfg,
mesh=...)`` over GSPMD-auto axes, whose ``cache_template`` puts ``head_dim``
on ``model`` wherever it divides tp (``hd_axis``).  The cases are reduced
configs whose kv heads do not split with the q heads:

* qwen2.5-14b (1 kv head, 5 q heads) at ``(1, 2)``, attention replicated
  (the rank slices the q it has), and with ``pad_attn_heads`` (6 q heads,
  3 a rank: the rank gathers every rank's q first);
* llama3.2-1b (2 kv heads, 4 q heads) at ``(1, 4)``;
* mixtral-8x22b at ``(1, 4)``: a rolling window of 32 slots, one lane
  decoding across its wrap (slots 30, 31, 0, 1);
* jamba-v0.1-52b at ``(1, 4)`` (its mamba channels split there too);
* qwen2.5-14b at ``(2, 2)`` with batch 1: the sequence on ``data`` and
  ``head_dim`` on ``model``.

One module fixture writes seeded float32 weights, a seeded whole cache and
tokens for each case (``_torch_tp_rank.seq_case_arrays``), then runs
at once the reference in one subprocess over 4 host devices (its cache
placed by its own specs) and the port in a world of two gloo ranks and one
of four (``tests/_torch_tp_rank.py seq``: each rank takes its slice of the
cache under the port's specs).  Each rank's logits of every decode step
equal the reference's rows within 1e-5; the gqa leaves' specs equal the
reference's, their local shapes the rank's slice; each step adds the
collectives of the design.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention as att
from repro_torch.models import lm
from repro_torch.models.common import sorted_leaves, tree_map

from _torch_tp_checks import close, serve_calls
from _torch_tp_rank import case_config, counts, run_seq_worlds

STEPS = 4

TWO = [
    dict(name="qwen_rep", arch="qwen2.5-14b", mesh=[1, 2],
         lengths=[14, 3, 27, 0]),
    dict(name="qwen_pad", arch="qwen2.5-14b", mesh=[1, 2],
         replace={"pad_attn_heads": True}, lengths=[14, 5]),
]
FOUR = [
    dict(name="llama_tp4", arch="llama3.2-1b", mesh=[1, 4],
         lengths=[14, 3, 27, 0]),
    dict(name="mixtral_wrap", arch="mixtral-8x22b", mesh=[1, 4],
         lengths=[30, 9]),
    dict(name="jamba_tp4", arch="jamba-v0.1-52b", mesh=[1, 4],
         lengths=[14, 5]),
    dict(name="qwen_long", arch="qwen2.5-14b", mesh=[2, 2], lengths=[14]),
]
MAX_SEQ = 32
CASES = TWO + FOUR
for _c in CASES:
    _c["max_seq"] = MAX_SEQ
NAMES = [c["name"] for c in CASES]
BY_NAME = dict(zip(NAMES, CASES))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the reference's outputs, {case name: [each rank's outputs]})."""
    return run_seq_worlds(tmp_path_factory.mktemp("hdsplit"),
                          {2: TWO, 4: FOUR}, STEPS)


def _gqa_layers(cfg) -> int:
    return sum(repeat for repeat, group in lm.make_program(cfg)
               for mixer, _ in group if mixer in ("gqa", "gqa_cross"))


def test_cases_split_head_dim():
    """Every case's gqa cache splits ``head_dim`` (its kv heads do not
    split with its q heads), and the q heads split where the case says."""
    for case in CASES:
        cfg = case_config(case)
        tp = case["mesh"][-1]
        assert lm.gqa_cache_split(cfg, tp, False) == "head_dim", case
        assert lm._splits("gqa", cfg, tp) == (case["name"] != "qwen_rep"
                                              and case["name"]
                                              != "qwen_long"), case


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_hd_split_decode_vs_reference(runs, name):
    """Each rank's logits of every decode step equal the reference's rows:
    all of a batch-1 cache's on every rank; its rows over data else."""
    ref, ranks = runs
    case = BY_NAME[name]
    batch = len(case["lengths"])
    D = case["mesh"][0]
    b = batch if batch == 1 else batch // D
    for r, out in enumerate(ranks[name]):
        k = 0 if batch == 1 else r // case["mesh"][-1]
        for i in range(STEPS):
            close(out[f"{name}/decode{i}"],
                  ref[f"{name}/decode{i}"][k * b:(k + 1) * b],
                  f"rank {r} step {i}")
        np.testing.assert_array_equal(
            out[f"{name}/length"],
            np.asarray(case["lengths"])[k * b:(k + 1) * b] + STEPS)


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_hd_split_specs_and_slices(runs, name):
    """The gqa ``k``/``v`` specs equal the reference's ``cache_template``
    specs (``head_dim`` on ``model``), every other leaf's batch entry too;
    a rank holds ``head_dim / tp`` columns of every kv head (and, for the
    batch-1 case, its chunk of the sequence over ``data``)."""
    ref, ranks = runs
    case = BY_NAME[name]
    cfg = case_config(case)
    D, M = case["mesh"]
    want = json.loads(str(ref[f"{name}/specs"]))
    for out in ranks[name]:
        got = json.loads(str(out[f"{name}/specs"]))
        shapes = json.loads(str(out[f"{name}/local_shapes"]))
        assert sorted(got) == sorted(want)
        split = 0
        for path, spec in got.items():
            g, w = json.loads(spec), json.loads(want[path])
            if path.split("/")[-2:] in (["mixer", "k"], ["mixer", "v"]):
                split += 1
                assert g == w and g[4] == "model", (path, g, w)
                seq = MAX_SEQ // D if len(case["lengths"]) == 1 else MAX_SEQ
                assert shapes[path][2:] == [seq, cfg.num_kv_heads,
                                            cfg.head_dim // M], path
            elif path != "length":
                assert g[:2] == w[:2], (path, g, w)
        assert split == 2 * len([1 for _, group in lm.make_program(cfg)
                                 for mixer, _ in group
                                 if mixer in ("gqa", "gqa_cross")])


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_hd_split_collectives_counted(runs, name):
    """Each decode step's collectives: the tp program's over ``model``
    (``serve_calls``), and for each gqa layer one ``psum`` of its float32
    partial scores (B x heads x positions) over ``model``, one
    ``all_gather`` of its float32 outputs' columns (B x heads x head_dim /
    tp) over ``model``, one of the new token's q over ``model`` where the
    q heads split, and, for the batch-1 cache, one ``all_gather`` of the
    flash partials over ``data``.  The bytes over ``model`` are those and
    the tp program's: the logits' gather and a psum of d_model float32 a
    lane for every other psum (jamba's mamba psums and gathers carry
    other widths, so only its calls are checked)."""
    _, ranks = runs
    case = BY_NAME[name]
    cfg = case_config(case)
    D, M = case["mesh"]
    long_ctx = len(case["lengths"]) == 1
    B = len(case["lengths"]) if long_ctx else len(case["lengths"]) // D
    S = MAX_SEQ // D if long_ctx else MAX_SEQ
    heads, hd, n = lm.q_heads(cfg, M), cfg.head_dim, STEPS * _gqa_layers(cfg)
    want = {(op, "model"): STEPS * c for op, c in
            serve_calls(cfg, M, False).items() if c}
    tp_psums = want.get(("psum", "model"), 0)
    want[("psum", "model")] = tp_psums + n
    gathers = n * (1 + lm._splits("gqa", cfg, M))
    want[("all_gather", "model")] = want.get(("all_gather", "model"), 0) \
        + gathers
    if long_ctx:
        want[("all_gather", "data")] = n
    psum_bytes = n * B * heads * S * 4 + tp_psums * B * cfg.d_model * 4
    gather_bytes = n * B * heads * hd // M * 4 \
        + STEPS * lm._tp(cfg.vocab_size, M) * B * cfg.vocab_size // M * 4
    if lm._splits("gqa", cfg, M):
        gather_bytes += n * B * heads // M * hd * 4
    for out in ranks[name]:
        stats = counts(out[f"{name}/stats_serve"])
        got = {}
        for k, v in stats.items():
            op, ax, _ = k.split("/")
            got[(op, ax)] = got.get((op, ax), 0) + v["calls"]
        assert got == want, (stats, want)
        if cfg.family != "hybrid":
            assert stats["psum/model/float32"]["bytes"] == psum_bytes, stats
            assert stats["all_gather/model/float32"]["bytes"] == \
                gather_bytes, stats


# ------------------------------------------------------ the in-place write
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trailing", [(3, 4), (6,)])
def test_write_into_equals_blend(dtype, trailing):
    """``attention._write_into`` writes the rows of ``_write_at`` (a
    (B, S, Hkv, d) cache) and ``_write_at2`` (a (B, S, D) latent) bit for
    bit into the cache's own tensor; a row whose length lies outside [0,
    S) (-1, S, S + 5) stays as it was."""
    gen = torch.Generator().manual_seed(len(trailing))
    B, S = 6, 8
    cache = torch.randn((B, S, *trailing), generator=gen).to(dtype)
    row = torch.randn((B, 1, *trailing), generator=gen)
    length = torch.tensor([-1, 0, 3, 7, 8, 13], dtype=torch.int32)
    blend = att._write_at if len(trailing) == 2 else att._write_at2
    want = blend(cache, row, length)
    got = cache.clone()
    out = att._write_into(got, row, length)
    assert out is got
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    for b in (0, 4, 5):
        assert torch.equal(got[b], cache[b])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b",
                                  "jamba-v0.1-52b", "rwkv6-1.6b",
                                  "deepseek-v3-671b", "whisper-large-v3"])
def test_inplace_decode_step_equals_functional(arch):
    """``LM.decode_step(inplace=True)`` gives the functional step's logits
    and cache bit for bit, for every family's cache leaves (the sequence
    caches written by row, the recurrent states copied in), and hands back
    the cache's own tensors; the functional step leaves its input as it
    was.  bf16, from a seeded cache at lengths that include a full lane
    (its write is dropped) and, for mixtral, the rolling window's wrap."""
    cfg = get_config(arch, reduced=True)
    model = lm.LM(cfg, device="cpu")
    params = model.init(3)
    max_seq = 32
    lengths = [30, 0, 31, 32] if arch == "mixtral-8x22b" else [5, 0, 31, 32]
    gen = torch.Generator().manual_seed(4)
    cache = model.init_cache(len(lengths), max_seq)
    for path, c in sorted_leaves(cache):
        if path == ("length",):
            c.copy_(torch.tensor(lengths, dtype=torch.int32))
        else:
            c.copy_(torch.randn(c.shape, generator=gen).to(c.dtype))
    fixed = tree_map(torch.clone, cache)
    own = tree_map(torch.clone, cache)
    ptrs = [c.data_ptr() for _, c in sorted_leaves(own["stages"])]
    toks = torch.randint(1, cfg.vocab_size, (len(lengths), 3), generator=gen,
                         dtype=torch.int32)
    with torch.no_grad():
        for i in range(3):
            l_f, new = model.decode_step(params, toks[:, i:i + 1], cache)
            for (_, a), (_, b) in zip(sorted_leaves(cache),
                                      sorted_leaves(fixed)):
                assert torch.equal(a, b)  # the functional step's input
            cache = fixed = new
            l_i, own = model.decode_step(params, toks[:, i:i + 1], own,
                                         inplace=True)
            assert torch.equal(l_f.view(torch.int16), l_i.view(torch.int16))
            for (p, a), (_, b) in zip(sorted_leaves(new),
                                      sorted_leaves(own)):
                assert torch.equal(a, b), p
            fixed = tree_map(torch.clone, cache)
    assert [c.data_ptr() for _, c in sorted_leaves(own["stages"])] == ptrs
