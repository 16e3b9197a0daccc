"""Checks shared by ``tests/test_torch_tp_families.py`` and
``tests/test_torch_tp_serving.py``: a world of ranks (``_torch_tp_rank.py``
outputs) against ``repro``'s outputs for the same case, and the
collectives a case's serving calls must make.

A rank ``r`` of a ``(D, M)`` mesh is ``(d, m) = divmod(r, M)``; it holds
the batch rows of ``d`` and the shards of ``m``.  Its logits are compared
with the reference's rows; its loss is the mean over its rows, so the
mean over ``d`` of the ranks' losses is the reference's, and so is the
mean over ``d`` of their gradients of each shard (each a slice of the
reference's gradient).
"""

import numpy as np

from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models.common import sorted_leaves

from _torch_tp_rank import DECODE_STEPS, case_config, counts, path_key, \
    rank_mesh

TOL = 1e-5


def close(got, want, what: str, scale: float = 1.0) -> None:
    """Within TOL elementwise (relative and absolute); ``scale`` multiplies
    the absolute term."""
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL * scale, err_msg=what)


def check_serving(ref, ranks, case) -> None:
    """Every rank's prefill logits (the whole vocabulary) and decode steps
    equal the reference's on the rank's rows."""
    name, (D, M) = case["name"], case["mesh"]
    for r, out in enumerate(ranks):
        d = r // M
        for f in ["prefill"] + [f"decode{i}" for i in range(DECODE_STEPS)]:
            want = ref[f"{name}/{f}"]
            b = want.shape[0] // D
            close(out[f"{name}/{f}"], want[d * b:(d + 1) * b],
                  f"rank {r} {f}")


def check_grads(ref, ranks, case) -> int:
    """The loss, and each leaf's gradient of each ``model`` shard (means
    over the data ranks) against the reference's slice -> the leaves
    checked.  A gradient is held to TOL of its leaf's scale (the absolute
    term times the largest magnitude of the reference's leaf, at least
    1): an element is a sum of many float32 terms, which the sharded
    program adds in another order, and its rounding error follows the
    leaf's scale, not its own (jamba's embedding, whose rows reach 2.7,
    moves by 1.1e-5 between the two packages run whole)."""
    name, (D, M) = case["name"], case["mesh"]
    cfg = case_config(case)
    specs = dict((path_key(p), s) for p, s in
                 sorted_leaves(lm.param_pspecs(cfg, M)))
    for m in range(M):
        group = [ranks[d * M + m] for d in range(D)]
        close(np.mean([o[f"{name}/loss"] for o in group]),
              ref[f"{name}/loss"], f"model rank {m} loss")
        mesh = rank_mesh((D, M), m)
        for k, spec in specs.items():
            want = ref[f"{name}/g/{k}"]
            want = want[mesh_mod.local_index(want.shape, spec, mesh)]
            got = np.mean([o[f"{name}/g/{k}"] for o in group], axis=0)
            assert got.shape == want.shape, k
            close(got, want, f"model rank {m} grad {k}",
                  scale=max(1.0, float(np.abs(ref[f"{name}/g/{k}"]).max())))
    n = len([k for k in ref if k.startswith(f"{name}/g/")])
    assert n == len(specs)
    return n


def serve_calls(cfg, tp: int, encoder: bool) -> dict:
    """The collectives over ``model`` of one serving call (a prefill with
    ``encoder`` run, or a decode step): ``{"psum": n, "all_gather": n}``.
    A split gqa mixer, mla mixer, MLP, MoE (``moe_spmd``, or
    ``moe_gather_spmd`` at decode) and encoder attention or MLP take one
    psum; whisper's decoder layer two (its cross-attention); rwkv one for
    the time mix and one for the channel mix; mamba two (``w_bcdt`` and
    ``w_out``) and one ``all_gather`` (the exchange of ``w_in``'s halves).
    The embedding takes one psum and the logits one ``all_gather`` when
    the vocabulary splits."""
    psum = gather = 0
    mixer_calls = {"gqa": (1, 0), "gqa_cross": (2, 0), "mla": (1, 0),
                   "rwkv": (1, 0), "mamba": (2, 1)}
    for repeat, group in lm.make_program(cfg):
        for mixer, ffn in group:
            if lm._splits(mixer, cfg, tp):
                ps, ag = mixer_calls[mixer]
                psum, gather = psum + repeat * ps, gather + repeat * ag
            if ffn in ("mlp", "rwkv_cm"):
                psum += repeat * lm._tp(cfg.d_ff, tp)
            elif ffn == "moe":
                psum += repeat * lm._tp(cfg.moe.num_experts, tp)
    if encoder:
        psum += cfg.encoder_layers * (lm._splits("gqa", cfg, tp)
                                      + lm._tp(cfg.d_ff, tp))
    vp = lm._tp(cfg.vocab_size, tp)
    return {"psum": psum + vp, "all_gather": gather + vp}


def check_serve_collectives(ranks, case, *, batch: int, seq: int) -> None:
    """Each rank's collectives over one prefill and DECODE_STEPS decode
    steps: the calls :func:`serve_calls` gives, all over ``model``, and
    bytes of every ``all_gather`` (float32): the logits' rows of the
    rank's vocabulary and, for each split mamba layer, the rank's columns
    of ``w_in``'s output."""
    name, (D, M) = case["name"], case["mesh"]
    cfg = case_config(case)
    pre = serve_calls(cfg, M, cfg.is_encdec) if M > 1 else {}
    dec = serve_calls(cfg, M, False) if M > 1 else {}
    want = {op: pre[op] + DECODE_STEPS * dec[op] for op in pre}
    b = batch // D
    gather_bytes = 0
    if M > 1 and lm._tp(cfg.vocab_size, M):
        gather_bytes += (1 + DECODE_STEPS) * b * (cfg.vocab_size // M) * 4
    n_mamba = sum(repeat for repeat, group in lm.make_program(cfg)
                  for mixer, _ in group if mixer == "mamba")
    if M > 1 and n_mamba and lm._splits("mamba", cfg, M):
        di = cfg.mamba.expand * cfg.d_model
        gather_bytes += n_mamba * b * (seq + DECODE_STEPS) * 2 * di // M * 4
    for out in ranks:
        stats = counts(out[f"{name}/stats_serve"])
        got = {op: sum(v["calls"] for k, v in stats.items()
                       if k.startswith(op + "/")) for op in want}
        assert got == want, (stats, want)
        assert all(k.split("/")[1] == "model" for k in stats), stats
        assert sum(v["bytes"] for k, v in stats.items()
                   if k.startswith("all_gather/")) == gather_bytes, stats


def round_trips(ranks, case) -> bool:
    return all(bool(out[f"{case['name']}/round_trip"]) for out in ranks)
