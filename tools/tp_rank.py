#!/usr/bin/env python3
"""One rank of a world of ``chip_smoke.py`` phases 17, 18 and 20, on one
NVIDIA card.

    python3 tools/tp_rank.py probe INIT RANK OUT
    python3 tools/tp_rank.py main INIT RANK OUT
    python3 tools/tp_rank.py reduced INIT RANK OUT
    python3 tools/tp_rank.py seq INIT RANK OUT
    python3 tools/tp_rank.py seq_reduced INIT RANK OUT
    python3 tools/tp_rank.py hd INIT RANK OUT

Each joins a world of two ranks (``hd``: sixteen; a ``file://``
rendezvous at ``INIT``) whose process group serves both CPU and card
tensors with gloo, every rank on ``cuda:0``: NCCL refuses two ranks on one
device.  It imports only
torch, numpy and ``repro_torch``, and writes its results to ``OUT`` as
JSON (an ``"error"`` key if it failed).

``probe`` tries ``all_reduce``, ``all_gather`` and ``send``/``recv`` on
bfloat16, float32 and int8 card tensors, writing what worked (and the host
µs of a 40 KB bf16 ``all_reduce``) after each try, so a rank that dies on
a try still leaves what came before.

``main`` runs the phase over a ``(1, 2)`` mesh (``launch.mesh``; gloo,
``ppermute`` as an ``all_gather``): (b) each SERVED config at tp = 2
through ``Engine`` (qwen2.5-14b cut to 24 layers, mixtral-8x22b to 4
through ``moe_spmd``, deepseek-v3-671b to its 3 dense layers and one MoE
layer, jamba-v0.1-52b to one period of 8 layers, rwkv6-1.6b to 12 and
whisper-large-v3's decoder to 16; whisper also prefills over encoder
frames, which runs the sharded encoder, whole), (c) each one's float32 twin (TWIN_LAYERS
layers; the MoE twins with the same routing and the same dropped picks)
against tp = 1 on rank 0, (d) mixtral-8x22b again with
``moe_gather_decode`` and its twin, llama3.2-1b served over ``(2, 1)`` (8
lanes, 4 a rank) and its twin on the same lanes, (e) llama3.2-1b trained
2 steps over each of ``(1, 2)`` (tp, vocab-parallel
cross entropy, its first step held to the plain step on the same batch),
``(2, 1)`` (ZeRO-1) and ``(2, 1, 1)`` (the int8 pod exchange, POD_LAYERS of
its layers, held to the plain step on the global batch, and again at the
reference's own test's size), each mesh's launches counted over its own
steps and checked against the program, and a float32 twin of the
``(2, 1)`` step against the plain step, (f) one float32 ``(1, 2)`` train
step of each of the four families of (b) whose mixers are not gqa, at its
reduced config, against the plain step on rank 0.  ``reduced`` runs the
twins and (f) at the reduced configs (the on-card tests' world).

``seq`` runs phase 18, the sequence splits of the decode cache: (a)
jamba-v0.1-52b, one 8-layer period at its published widths, a batch-1
cache of SEQ_MAX (524,288) tokens over ``(2, 1)``, its sequence split over
``data``, filled from the seed to SEQ_FILL and SEQ_NEW tokens decoded
through ``Engine(lanes=1)``; (b) llama3.2-1b whole at ``(1, 2)`` under
``cache_seq_shard``, SHARD_LANES lanes of SHARD_MAX filled to
SHARD_LENGTHS (the last with no live position on rank 1), decoded through
``Engine``; (c) the float32 twins of SEQ_TWINS, each split run against the
same model and seeded cache unsplit on rank 0.  ``seq_reduced`` runs the
twins at the reduced configs (the on-card tests' world).

``hd`` runs phase 20, the gqa decode cache split over ``head_dim``:
llama3.2-1b at its published widths and depth in bf16 over ``(1, 16)``,
each rank holding ``decode_32k``'s share of one rank of the reference's
``(16, 16)`` mesh (8 lanes of 32,768 positions from :func:`seeded_cache`,
head_dim 64 / 16 = 4 columns of each of the 8 kv heads), decoding a few
greedy steps in place (``decode_step(inplace=True)``); then the float32
twin over the same mesh at a cut cache, whose logits rank 0 saves for the
parent.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import sys
import time

from pathlib import Path

_STARTED = time.time()  # the wall clock when this rank's imports began
_PARENT = os.getppid()
if os.environ.get("TP_WORLD_GATE"):  # started early, beside other work
    os.nice(10)  # chip_smoke.BG_NICE

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (fused_per_decode_step, fused_per_prefill,  # noqa: E402
                        recording_shapes)
from repro_torch.models.common import sorted_leaves  # noqa: E402

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8}
PROBE_ELEMS = 20480  # 40 KB of bf16: a decode step's psum at d = 5120
PROBE_ITERS = 200


def _write(out: str, res: dict) -> None:
    with open(out, "w") as f:
        json.dump(res, f)


def _probe_op(op: str, dtype, rank: int) -> None:
    """One collective on card tensors, its result checked."""
    dev = torch.device("cuda", 0)
    x = torch.full((PROBE_ELEMS,), rank + 1, dtype=dtype, device=dev)
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = bool((x == 3).all())
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        ok = bool((parts[0] == 1).all() and (parts[1] == 2).all())
    else:  # send / recv: rank 0 sends, rank 1 receives
        if rank == 0:
            dist.send(x, 1)
            ok = True
        else:
            y = torch.zeros_like(x)
            dist.recv(y, 0)
            ok = bool((y == 1).all())
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError(f"{op} gave a wrong result")


def probe(init: str, rank: int, out: str) -> int:
    dist.init_process_group("cpu:gloo,cuda:gloo", init_method=f"file://{init}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    torch.cuda.set_device(0)
    res = {"backend": dist.get_backend_config(), "ops": {}}
    _write(out, res)
    try:
        for op in ("all_reduce", "all_gather", "send_recv"):
            for name, dtype in DTYPES.items():
                key = f"{op}/{name}"
                res["ops"][key] = "trying"
                _write(out, res)
                try:
                    _probe_op(op, dtype, rank)
                    res["ops"][key] = "ok"
                except Exception as e:  # noqa: BLE001 - the probe's answer
                    res["ops"][key] = f"{type(e).__name__}: {e}"[:300]
                _write(out, res)
            if op == "all_reduce" and res["ops"]["all_reduce/bfloat16"] == "ok":
                x = torch.zeros(PROBE_ELEMS, dtype=torch.bfloat16,
                               device="cuda")
                ts = []
                for _ in range(PROBE_ITERS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    dist.all_reduce(x)
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t0) * 1e6)
                res["all_reduce_40KB_us"] = dict(
                    p50=float(np.percentile(ts, 50)),
                    p99=float(np.percentile(ts, 99)))
                _write(out, res)
    finally:
        dist.destroy_process_group()
    return 0


# ----------------------------------------------------------------- main
SEED = 0
# the engine prefills a prompt token by token, each a whole-batch decode
# step, so a run makes about REQUESTS / LANES x (LANES x mean prompt + NEW)
# calls: one wave of short prompts, about 16 calls (8 requests of 6-12 +
# 16 tokens until the phase served eight configs: 106 calls a run, 310 s
# of world)
LANES, MAX_SEQ, REQUESTS, PROMPT, NEW = 4, 64, 4, (1, 3), 8
PROFILED_STEPS = 4
TWIN_LAYERS, TWIN_TOL, TWIN_STEPS = 2, 1e-4, 3
TRAIN_B, TRAIN_SEQ, TRAIN_LR = 2, 512, 1e-3  # B a rank
TRAIN_TWIN_SEQ, TRAIN_TWIN_TOL = 128, 1e-5
# the (2, 1, 1) mesh trains 8 of llama3.2-1b's 16 layers: each rank keeps a
# whole AdamW state and the exchange's float32 ef; the functional update
# held the old and the new state at once, 38.25 GiB a rank at 16 layers,
# more than two ranks (and the parent process) found on one card.  The
# steps are in place now (one state a rank), and the depth is kept
POD_LAYERS = 8
# the (2, 1) ZeRO-1 mesh trains 8 of the 16 layers too since qwen3-4b's
# training came to phase 14: at 16 its two steps took 13.7 s of the world
# (7963.8 and 5752.0 ms; gloo stages the gradient's psum and each leaf's
# all_gather through the host)
ZERO_LAYERS = 8
TRAIN_STEPS = 2
# fused_norm_matmul entries of a llama3.2-1b layer (q, k, v, gate, up): a
# train step launches row 5 twice for each (the remat of the layer's group
# runs its forward again in the backward) and row 6 once
TRAIN_ENTRIES = 5
# the (1, 2) step against the plain step on the same batch, both bf16 and
# summed in other orders: the loss within TP_LOSS_TOL, and each TP_LEAVES
# leaf's gradient (read through Adam's first moment) and update, gathered
# whole, by their cosines to the plain step's
TP_LEAVES = (("embed",), ("stages", 0, 0, "mixer", "wq"),
             ("stages", 0, 0, "mixer", "wo"))
TP_LOSS_TOL = 1e-2
GRAD_COSINE_MIN = 0.99
# the update's cosine to the plain step's must pass the int8 pod step's
# bound in the reference's own test (tests/test_train_serve.py)
UPDATE_COSINE_MIN = 0.8
# the (2, 1, 1) step's leaves: at full width the embedding's update cosine
# is recorded (the int8 scale of its 263M elements zeroes the small
# softmax gradients that Adam's first step moves by lr), the others' gated
POD_LEAVES = (("embed",), ("stages", 0, 0, "mixer", "wq"))
POD_GATED = POD_LEAVES[1:]
# (d, F) of each row-5 launch of a decode step at tp = 2 (deepseek's
# wq_a and wkv_a are replicated, whole; rwkv has no fused entry), and of
# llama3.2-1b's over (2, 1), whole
SHARD_SHAPES = {"qwen2.5-14b": {(5120, 2560), (5120, 512), (5120, 6912)},
                "mixtral-8x22b": {(6144, 3072), (6144, 512)},
                "deepseek-v3-671b": {(7168, 1536), (7168, 576),
                                     (1536, 12288), (7168, 9216),
                                     (7168, 1024)},
                "jamba-v0.1-52b": {(4096, 8192), (4096, 2048), (4096, 512),
                                   (4096, 7168)},
                "rwkv6-1.6b": set(),
                "whisper-large-v3": {(1280, 640), (1280, 2560)},
                "llama3.2-1b": {(2048, 2048), (2048, 512), (2048, 8192)}}
# deepseek: its 3 dense layers and one MoE layer (the MTP block's leaves
# are drawn; serving does not run it); jamba: one 8-layer period; qwen2.5-14b
# (48 layers), rwkv6-1.6b (24) and whisper-large-v3's decoder (32, its
# encoder whole) at half depth since phase 20 came (their decode calls
# took 471, 403 and 699 ms a step on a slow host)
SERVED = (("qwen2.5-14b", 24), ("mixtral-8x22b", 4),
          ("deepseek-v3-671b", 4), ("jamba-v0.1-52b", 8),
          ("rwkv6-1.6b", 12), ("whisper-large-v3", 16))
# the twins of the MoE families at full width cut the experts to
# TWIN_EXPERTS (a float32 deepseek MoE layer of 256 experts is 45 GB, and
# the twin holds the tp = 2 shards, then the whole program); jamba's twin
# is one "ma" period (mamba + MLP, attention + MoE): 8 layers is a period
TWIN_EXPERTS = 16
# whisper's prefill: WHISPER_ROWS rows of WHISPER_PROMPT tokens behind
# frames of (WHISPER_ROWS, encoder_seq, d)
WHISPER_ROWS, WHISPER_PROMPT = 2, 16
# the (2, 1) serving run: DATA_LANES lanes over the mesh, each rank its
# half, each rank REQUESTS requests of its own
DATA_LANES = 8
TRAIN_FAMILIES = ("deepseek-v3-671b", "jamba-v0.1-52b", "rwkv6-1.6b",
                  "whisper-large-v3")
TRAIN_FAMILY_B, TRAIN_FAMILY_SEQ = 2, 32


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _pcts(ms) -> dict:
    ms = np.asarray(ms)
    return dict(p50=float(np.percentile(ms, 50)),
                p99=float(np.percentile(ms, 99)))


@contextlib.contextmanager
def _recorded(mesh, shape_of):
    """Row 5's calls recorded into the yielded dict's ``shapes`` (each
    ``shape_of(x, w)``), the launch counters and ``mesh``'s counts zeroed
    on entry and read into its ``launches`` and ``stats`` on exit."""
    from repro_torch.kernels import ops
    fnm, rec = ops.fused_norm_matmul, {"shapes": set()}

    def recording_fnm(x, gamma, w):
        rec["shapes"].add(shape_of(x, w))
        return fnm(x, gamma, w)

    ops.fused_norm_matmul = recording_fnm
    try:
        ops.reset_launch_counts()
        mesh.reset_stats()
        yield rec
        rec.update(launches=dict(ops.LAUNCHES), stats=mesh.stats_json())
    finally:
        ops.fused_norm_matmul = fnm


def _timed_run(eng, mesh, shape_of) -> dict:
    """``eng.run()`` with every ``_step`` call synced and timed and row
    5's shapes recorded (``shape_of(x, w)``), the launch counters and the
    mesh's counts zeroed just before and read just after.  The first call
    (the first prompt token's, which warms the allocator and the caches)
    is reported apart, as ``first_call_ms``; the p50 and p99 of
    ``decode_step_ms`` and ``generated_tokens_per_s`` are over the calls
    after it (``generated_tokens_per_s_with_first`` over the whole
    run)."""
    step, times = eng._step, []

    def timed_step(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(*a)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    eng._step = timed_step
    try:
        with _recorded(mesh, shape_of) as rec:
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    finally:
        eng._step = step
    ms = np.asarray(times) * 1e3
    return dict(times=times, shapes=rec["shapes"], launches=rec["launches"],
                stats=rec["stats"], run_s=run_s,
                first_call_ms=float(ms[0]),
                decode_step_ms=_pcts(ms[1:] if len(ms) > 1 else ms),
                steady_s=run_s - times[0])


def _rates(generated: int, run: dict) -> dict:
    return dict(generated_tokens_per_s=generated / run["steady_s"],
                generated_tokens_per_s_with_first=generated / run["run_s"],
                first_call_ms=run["first_call_ms"],
                decode_step_ms=run["decode_step_ms"])


def _config(arch: str, layers=None):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _twin_config(arch: str, **replace):
    """``arch`` cut for its float32 twin: TWIN_LAYERS layers (deepseek one
    dense and one MoE layer, jamba one "ma" period, whisper as many
    encoder layers), at most TWIN_EXPERTS experts."""
    import dataclasses
    cfg = _config(arch, TWIN_LAYERS)
    kw = dict(dtype="float32", **replace)
    if cfg.layer_pattern:
        kw["layer_pattern"] = "ma"
    if cfg.is_encdec:
        kw["encoder_layers"] = TWIN_LAYERS
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, TWIN_EXPERTS),
            first_k_dense=min(cfg.moe.first_k_dense, TWIN_LAYERS - 1))
    return dataclasses.replace(cfg, **kw)




def _requests(vocab: int, seed_offset: int = 0) -> list:
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + seed_offset)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(
        1, vocab, int(rng.integers(PROMPT[0], PROMPT[1] + 1)))],
        max_new=NEW) for i in range(REQUESTS)]


def _busy_us(prof) -> tuple:
    """The union of a trace's device intervals (us) and its device ops."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, len(spans)


def _profile_decode(model, params, cache) -> dict:
    from torch.profiler import ProfilerActivity, profile
    tokens = torch.ones((cache["length"].shape[0], 1), dtype=torch.int32,
                        device=model.device)
    model.decode_step(params, tokens, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            logits, cache = model.decode_step(params, tokens, cache)
            tokens = torch.argmax(logits, -1).int()[:, None]
            tokens.tolist()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    busy, n = _busy_us(prof)
    return dict(profiled_step_ms=wall / PROFILED_STEPS / 1e3,
                device_busy_share=busy / wall if n else None,
                device_ops_per_step=n / PROFILED_STEPS)


def serve_tp(arch: str, layers, mesh, *, lanes: int = LANES,
             **replace) -> dict:
    """One model over ``mesh`` through ``Engine``: random bf16 weights
    drawn on the card (each rank keeps its shards), REQUESTS requests a
    rank (each rank its own over a data axis, its ``lanes`` share of the
    lanes), every decode_step call timed, row 5's (d, F) recorded, the
    launch counters and the mesh's counts zeroed just before the run and
    read after; whisper then prefills over encoder frames (its sharded
    encoder), counted likewise."""
    import dataclasses
    import gc
    from repro_torch.kernels import ops
    from repro_torch.models.common import count_params, tree_leaves
    from repro_torch.models.lm import LM
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(_config(arch, layers), **replace)
    data = mesh.axis_index(("pod", "data"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, mesh=mesh)
    params = model.init(SEED)
    torch.cuda.synchronize()
    res = dict(model=arch, layers=cfg.num_layers, tp=model.tp,
               init_s=time.perf_counter() - t0,
               params_local=count_params(params),
               param_bytes_local=sum(t.numel() * t.element_size()
                                     for t in tree_leaves(params)),
               init_max_memory_allocated=torch.cuda.max_memory_allocated())
    check(all(t.device == mesh.device and t.is_contiguous()
              for t in tree_leaves(params)),
          f"{arch}: a shard is not a contiguous tensor on the card")
    eng = Engine(model, params, lanes=lanes, max_seq=MAX_SEQ)
    reqs = _requests(cfg.vocab_size, data)
    for r in reqs:
        eng.submit(r)
    run = _timed_run(eng, mesh,
                     lambda x, w: (int(x.shape[-1]), int(w.shape[-1])))
    launches, stats, shapes = run["launches"], run["stats"], run["shapes"]
    calls = len(run["times"])
    check(eng.stats.finished == REQUESTS
          and all(len(r.out) == NEW for r in reqs),
          f"{arch}: a request did not finish with its {NEW} tokens")
    check(shapes == SHARD_SHAPES[arch],
          f"{arch}: row 5 ran at (d, F) {sorted(shapes)}, not the shard "
          f"shapes {sorted(SHARD_SHAPES[arch])}")
    per_call = fused_per_decode_step(cfg)
    check(launches["fused_norm_matmul"] == per_call * calls,
          f"{arch}: {launches['fused_norm_matmul']} row-5 launches in "
          f"{calls} decode_step calls, not {per_call} a call")
    out = torch.tensor([r.out for r in reqs], device=mesh.device)
    if mesh.shape["model"] > 1:
        both = mesh.all_gather(out[None], "model", dim=0)
        res["tokens_equal_on_ranks"] = bool(torch.equal(both[0], both[1]))
        check(res["tokens_equal_on_ranks"],
              f"{arch}: the two ranks generated different tokens")
    res.update(fnm_per_call=per_call, lanes_local=eng.lanes)
    generated = sum(len(r.out) for r in reqs)
    res.update(
        requests=REQUESTS, decode_step_calls=calls,
        decode_steps=eng.stats.decode_steps, run_s=run["run_s"],
        **_rates(generated, run),
        row5_shapes=sorted(shapes), launches=launches,
        collectives=stats,
        collectives_per_call={k: dict(calls=v["calls"] / calls,
                                      bytes=v["bytes"] / calls,
                                      host_ms=v["s"] * 1e3 / calls)
                              for k, v in stats.items()})
    res.update(_profile_decode(model, params, eng.cache))
    if cfg.is_encdec:
        res["prefill"] = encdec_prefill(model, params, mesh)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del eng, model, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def encdec_prefill(model, params, mesh) -> dict:
    """whisper's ``LM.prefill`` of WHISPER_ROWS x WHISPER_PROMPT tokens over
    seeded bf16 frames of (WHISPER_ROWS, encoder_seq, d): the sharded
    encoder, then the decoder.  Once to warm up, then timed with the
    launch counters and the mesh's counts zeroed just before and read
    after; row 5's launches must be the program's (the encoder's gqa and
    MLP entries a layer, and the decoder's), its (S, d, F) recorded."""
    cfg = model.cfg
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(SEED)
    frames = torch.randn((WHISPER_ROWS, cfg.encoder_seq, cfg.d_model),
                         generator=gen, device=mesh.device,
                         dtype=torch.bfloat16)
    tokens = torch.randint(1, cfg.vocab_size, (WHISPER_ROWS, WHISPER_PROMPT),
                           generator=gen, device=mesh.device,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "frames": frames}
    with torch.no_grad():
        model.prefill(params, batch)
        torch.cuda.synchronize()
        with _recorded(mesh, lambda x, w: (x.numel() // x.shape[-1],
                                           int(x.shape[-1]),
                                           int(w.shape[-1]))) as rec:
            t0 = time.perf_counter()
            logits = model.prefill(params, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    launches, shapes = rec["launches"], rec["shapes"]
    want = fused_per_prefill(cfg)
    check(launches["fused_norm_matmul"] == want,
          f"{cfg.name} prefill: {launches['fused_norm_matmul']} row-5 "
          f"launches, not the program's {want}")
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (WHISPER_ROWS, cfg.vocab_size),
          f"{cfg.name} prefill: logits {tuple(logits.shape)} not finite")
    return dict(ms=ms, rows=WHISPER_ROWS, prompt=WHISPER_PROMPT,
                frames=list(frames.shape), launches=launches,
                row5_shapes=sorted(shapes), collectives=mesh.stats_json())


def twin(arch: str, mesh, **replace) -> dict:
    """``arch`` cut for its twin (:func:`_twin_config`) at full width in
    float32: the tp = 2 model's prefill logits (whisper's over seeded
    frames) and TWIN_STEPS decode steps against the tp = 1 model's from
    the same seed on rank 0, within TWIN_TOL and with the same argmax; for
    MoE, the same routing and the same bins (rank 0's tp = 1 bins against
    both ranks' spmd bins, gathered)."""
    import gc
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import LM, init_params
    cfg = _twin_config(arch, **replace)
    rank0 = mesh.axis_index("model") == 0
    rng = np.random.default_rng(SEED + 1)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (LANES, 8))
                            .astype(np.int32)).to(mesh.device)
    inputs = {"tokens": toks}
    if cfg.is_encdec:
        inputs["frames"] = torch.from_numpy(rng.standard_normal(
            (LANES, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(
                mesh.device)
    router, spmd, whole = moe_mod.router_probs, moe_mod.spmd_bins, \
        moe_mod.bins
    routed, lanes = {"tp2": [], "tp1": []}, {"tp2": [], "tp1": []}
    which = ["tp2"]

    def rec_router(*a, **k):
        out = router(*a, **k)
        routed[which[0]].append(out[1])
        return out

    def rec_spmd(*a, **k):
        out = spmd(*a, **k)
        lanes["tp2"].append(out[0])
        return out

    def rec_bins(*a, **k):
        out = whole(*a, **k)
        lanes["tp1"].append(out[0])
        return out

    def run(model, params):
        with torch.no_grad():
            outs = [model.prefill(params, inputs)]
            cache = model.init_cache(LANES, 16)
            for i in range(TWIN_STEPS):
                logits, cache = model.decode_step(params, toks[:, i:i + 1],
                                                  cache)
                outs.append(logits)
        return outs

    moe_mod.router_probs, moe_mod.spmd_bins = rec_router, rec_spmd
    try:
        m2 = LM(cfg, mesh=mesh)
        got = run(m2, init_params(cfg, SEED, dtype=torch.float32, mesh=mesh))
    finally:
        moe_mod.router_probs, moe_mod.spmd_bins = router, spmd
    gc.collect()
    torch.cuda.empty_cache()
    res = {"layers": cfg.num_layers, "experts": (
        cfg.moe.num_experts if cfg.moe is not None else None)}
    if cfg.moe is not None:  # both ranks' bins, whole, on every rank
        lanes["tp2"] = [mesh.all_gather(t, "model") for t in lanes["tp2"]]
    if rank0:
        which[0] = "tp1"
        moe_mod.router_probs, moe_mod.bins = rec_router, rec_bins
        try:
            # one rank, the whole program, the same (padded) weights
            m1 = LM(cfg, tp=m2.tp, device=mesh.device)
            want = run(m1, init_params(cfg, SEED, device=mesh.device,
                                       dtype=torch.float32, tp=m2.tp))
        finally:
            moe_mod.router_probs, moe_mod.bins = router, whole
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        res.update(max_abs_err=max(errs), errs=errs, same_argmax=same)
        check(max(errs) <= TWIN_TOL and same,
              f"{arch} float32 twin: tp = 2 differs from tp = 1 by "
              f"{max(errs)} (argmax equal: {same})")
        if cfg.moe is not None:
            n = len(routed["tp1"])
            check(n == len(routed["tp2"]) > 0
                  and len(lanes["tp1"]) == len(lanes["tp2"]) > 0,
                  f"{arch} twin: {n} router calls and {len(lanes['tp1'])} "
                  f"binnings at tp = 1, {len(routed['tp2'])} and "
                  f"{len(lanes['tp2'])} at tp = 2")
            res["routing_equal"] = all(torch.equal(a, b) for a, b in zip(
                routed["tp1"], routed["tp2"]))
            res["bins_equal"] = all(torch.equal(a, b) for a, b in zip(
                lanes["tp1"], lanes["tp2"]))
            res["moe_calls"] = n
            check(res["routing_equal"] and res["bins_equal"],
                  f"{arch} twin: routing {res['routing_equal']}, bins "
                  f"(and so the dropped picks) {res['bins_equal']}")
        del m1, want
    del got
    gc.collect()
    torch.cuda.empty_cache()
    return res


def data_twin(arch: str, mesh) -> dict:
    """The (D, 1) serving twin: ``arch`` at TWIN_LAYERS in float32 over
    ``mesh``, each rank its rows of DATA_LANES seeded prompts (its lanes of
    the cache), prefill logits and TWIN_STEPS decode steps gathered over
    ``data``, against the whole program on all DATA_LANES rows on rank 0,
    within TWIN_TOL and with the same argmax."""
    import dataclasses
    import gc
    from repro_torch.models.lm import LM, init_params
    cfg = dataclasses.replace(_config(arch, TWIN_LAYERS), dtype="float32")
    n = mesh.axis_size(("pod", "data"))
    k = mesh.axis_index(("pod", "data"))
    rng = np.random.default_rng(SEED + 2)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (DATA_LANES, 8))
                            .astype(np.int32)).to(mesh.device)
    b = DATA_LANES // n

    def run(model, params, rows):
        with torch.no_grad():
            outs = [model.prefill(params, {"tokens": rows})]
            cache = model.init_cache(DATA_LANES, 16)
            for i in range(TWIN_STEPS):
                logits, cache = model.decode_step(params, rows[:, i:i + 1],
                                                  cache)
                outs.append(logits)
        return outs

    model = LM(cfg, mesh=mesh)
    mine = run(model, init_params(cfg, SEED, dtype=torch.float32, mesh=mesh),
               toks[k * b:(k + 1) * b])
    got = [mesh.all_gather(t, ("pod", "data")) for t in mine]
    res = {"layers": TWIN_LAYERS, "lanes": DATA_LANES, "lanes_local": b,
           "lanes_of_cache": int(model.init_cache(DATA_LANES, 16)[
               "length"].shape[0])}
    check(res["lanes_of_cache"] == b, f"{arch}: the rank's cache holds "
          f"{res['lanes_of_cache']} lanes, not {b}")
    del model, mine
    gc.collect()
    torch.cuda.empty_cache()
    if k == 0:
        m1 = LM(cfg, device=mesh.device)
        want = run(m1, init_params(cfg, SEED, device=mesh.device,
                                   dtype=torch.float32), toks)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        res.update(max_abs_err=max(errs), errs=errs, same_argmax=same)
        check(max(errs) <= TWIN_TOL and same,
              f"{arch} (D, 1) twin: the data-split program differs from the "
              f"whole one by {max(errs)} (argmax equal: {same})")
        del m1, want
    gc.collect()
    torch.cuda.empty_cache()
    return res


def family_train_twins(mesh12) -> dict:
    """(f): one float32 ``(1, 2)`` train step of each TRAIN_FAMILIES config
    at its reduced size (``get_config(reduced=True)``, whatever ``_config``
    is), both ranks on one seeded batch of TRAIN_FAMILY_B x
    TRAIN_FAMILY_SEQ tokens (whisper's with seeded frames), against the
    plain step on rank 0: the loss within TRAIN_TWIN_TOL, and every
    leaf's gradient (Adam's first moment, (1 - b1) g) and update, gathered
    whole, within TRAIN_TWIN_TOL of the leaf's scale.  The launch counters
    are zeroed just before the mesh's step and read after: each rank's
    count must equal the plain step's (the same entries, each rank with
    its shards), and the (S, d, F, dtype) of row 5's and row 6's calls are
    recorded."""
    import dataclasses
    import gc
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import gather_params
    from repro_torch.models.lm import LM, init_params
    from repro_torch.train import init_state, make_train_step
    tcfg = TrainConfig(learning_rate=TRAIN_LR)
    rank0 = mesh12.axis_index("model") == 0
    dev = mesh12.device
    out, launches = {}, {}
    shapes = {"fused_norm_matmul": set(), "fused_norm_matmul_bwd": set()}
    for arch in TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype="float32")
        rng = np.random.default_rng(SEED + 3)
        batch = _global_batch(cfg.vocab_size, TRAIN_FAMILY_B,
                              TRAIN_FAMILY_SEQ, SEED + 3, dev)
        if cfg.is_encdec:
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (TRAIN_FAMILY_B, cfg.encoder_seq, cfg.d_model)).astype(
                    np.float32)).to(dev)
        model = LM(cfg, mesh=mesh12)
        params = init_params(cfg, SEED, dtype=torch.float32, mesh=mesh12)
        pspecs = model.pspecs()
        state = init_state(params, mesh=mesh12, pspecs=pspecs)
        step = make_train_step(model, tcfg, inplace=True)
        torch.cuda.synchronize()
        state, r = _train_steps(step, state, batch, mesh12, 1)
        whole = gather_params({"p": state.params, "m": state.m}, {
            "p": pspecs, "m": pspecs}, mesh12)
        res = dict(loss=r["losses"][0], step_ms=r["step_ms"][0],
                   launches=r["launches"], collectives=r["collectives"])
        for name, sh in r["fnm_shapes"].items():
            shapes[name] |= set(map(tuple, sh))
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        del model, params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        if rank0:
            m0 = LM(cfg, device=dev)
            p0 = init_params(cfg, SEED, device=dev, dtype=torch.float32)
            ops.reset_launch_counts()
            s0, met = make_train_step(m0, tcfg)(init_state(p0), batch)
            torch.cuda.synchronize()
            plain = dict(ops.LAUNCHES)
            errs = {"m": 0.0, "update": 0.0}
            # the parameters start equal (one seed), so their difference
            # after the step is the updates'
            for (_, a), (_, b), (_, p1), (_, p2) in zip(
                    sorted_leaves(whole["m"]), sorted_leaves(s0.m),
                    sorted_leaves(whole["p"]), sorted_leaves(s0.params)):
                scale = max(1.0, float(b.abs().max()))
                errs["m"] = max(errs["m"], float((a - b).abs().max()) / scale)
                errs["update"] = max(errs["update"],
                                     float((p1 - p2).abs().max()))
            res.update(plain_loss=float(met["loss"]),
                       loss_diff=abs(res["loss"] - float(met["loss"])),
                       grad_err=errs["m"], update_err=errs["update"],
                       plain_launches=plain)
            check(res["loss_diff"] <= TRAIN_TWIN_TOL
                  and errs["m"] <= TRAIN_TWIN_TOL
                  and errs["update"] <= TRAIN_TWIN_TOL,
                  f"{arch} (1, 2) float32 step against the plain step: loss "
                  f"{res['loss_diff']}, gradient {errs['m']}, update "
                  f"{errs['update']}")
            check(all(r["launches"][k] == plain.get(k, 0)
                      for k in ("fused_norm_matmul",
                                "fused_norm_matmul_bwd")),
                  f"{arch}: the (1, 2) step launched {r['launches']}, the "
                  f"plain step {plain}")
            del m0, p0, s0
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = res
    out["launches"] = launches
    out["fnm_shapes"] = {k: sorted(v) for k, v in shapes.items()}
    return out


def _global_batch(vocab: int, n: int, seq: int, seed: int, device) -> dict:
    rng = np.random.default_rng(seed)
    return {f: torch.from_numpy(rng.integers(0, vocab, (n, seq)).astype(
        np.int32)).to(device) for f in ("tokens", "labels")}


def _leaf_sums(params) -> torch.Tensor:
    """Each leaf's bits summed (as int64): equal leaves, equal sums."""
    out = []
    for _, t in sorted_leaves(params):
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        out.append(bits.long().sum())
    return torch.stack(out)


def _train_steps(step, state, batch, mesh, n: int) -> tuple:
    """``n`` timed steps of ``step`` (the in-place step, the reference's
    donated state) -> (state, record).  The launch counters, the mesh's
    counts, the rank's peak memory and the allocator's retries (a free of
    its cache to satisfy an allocation) are zeroed just before the steps
    and read just after them, and the (S, d, F, dtype) of every row-5 and
    row-6 call is recorded."""
    from repro_torch.kernels import ops
    shapes = {"fused_norm_matmul": set(), "fused_norm_matmul_bwd": set()}
    ms, losses = [], []
    with recording_shapes(shapes):
        ops.reset_launch_counts()
        mesh.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
        launches, stats = dict(ops.LAUNCHES), mesh.stats_json()
        retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                                0) - retries
    return state, dict(step_ms=ms, losses=losses, alloc_retries=retries,
                       tokens=batch["tokens"].numel() * n, launches=launches,
                       collectives=stats,
                       fnm_shapes={k: sorted(v) for k, v in shapes.items()},
                       max_memory_allocated=torch.cuda.max_memory_allocated())


def _merge(r: dict, later: dict) -> dict:
    """``later``'s steps (a record of :func:`_train_steps`) added to
    ``r``'s."""
    for k in ("step_ms", "losses"):
        r[k] += later[k]
    r["alloc_retries"] += later["alloc_retries"]
    r["tokens"] += later["tokens"]
    for k, v in later["launches"].items():
        r["launches"][k] += v
    for k, v in later["collectives"].items():
        c = r["collectives"].setdefault(k, dict(calls=0, bytes=0, s=0.0))
        for f in c:
            c[f] += v[f]
    for k, v in later["fnm_shapes"].items():
        r["fnm_shapes"][k] = sorted(set(map(tuple, r["fnm_shapes"][k]))
                                    | set(map(tuple, v)))
    r["max_memory_allocated"] = max(r["max_memory_allocated"],
                                    later["max_memory_allocated"])
    return r


def _close(r: dict, what: str, layers: int) -> dict:
    """Check a mesh's launches against its program: each of a layer's
    TRAIN_ENTRIES row-5 entries twice a step (the forward and its remat)
    and its row-6 backward once, no other kernel."""
    steps = len(r["step_ms"])
    want = {k: 0 for k in r["launches"]}
    want.update(fused_norm_matmul=2 * TRAIN_ENTRIES * layers * steps,
                fused_norm_matmul_bwd=TRAIN_ENTRIES * layers * steps)
    r.update(expected_launches=want,
             tokens_per_s=r["tokens"] / (sum(r["step_ms"]) / 1e3))
    check(r["launches"] == want, f"{what}: launches {r['launches']} in "
          f"{steps} steps of {layers} layers, not {want}")
    return r


def zero_twin(cfg, tcfg, mesh21) -> tuple:
    """The float32 twin of the (2, 1) step: ``cfg`` cut to TWIN_LAYERS in
    float32, one ZeRO-1 step of each rank's half of a global batch, in
    place and functional from the same weights, equal bit for bit on each
    rank (params, ``m``, ``v``, the step, the loss); the in-place step
    against the plain step of the whole batch on rank 0, within
    TRAIN_TWIN_TOL -> (rank 0's largest parameter difference (None on rank
    1), whether the two steps agreed)."""
    import dataclasses
    import gc
    from repro_torch.models.lm import LM, init_params
    from repro_torch.train import init_state, make_train_step
    rank, dev = dist.get_rank(), mesh21.device
    cfg2 = dataclasses.replace(cfg, num_layers=TWIN_LAYERS, dtype="float32")
    glob2 = _global_batch(cfg.vocab_size, 2 * TRAIN_B, TRAIN_TWIN_SEQ,
                          SEED + 1, dev)
    model = LM(cfg2, mesh=mesh21)
    share = {k: v[rank * TRAIN_B:(rank + 1) * TRAIN_B]
             for k, v in glob2.items()}
    out = {}
    for inplace in (False, True):
        params = init_params(cfg2, SEED, dtype=torch.float32, mesh=mesh21)
        state = init_state(params, mesh=mesh21, pspecs=model.pspecs())
        out[inplace] = make_train_step(model, tcfg, inplace=inplace)(
            state, share)
        del params, state
    (state, met), (fstate, fmet) = out[True], out[False]
    same = torch.equal(met["loss"], fmet["loss"]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            sorted_leaves(state.tree()), sorted_leaves(fstate.tree())))
    check(same, f"float32 twin: rank {rank}'s in-place (2, 1) step differs "
          f"from the functional one")
    del out, fstate
    err = None
    if rank == 0:
        m0 = LM(cfg2, device=dev)
        p0 = init_params(cfg2, SEED, device=dev, dtype=torch.float32)
        s0, _ = make_train_step(m0, tcfg)(init_state(p0), glob2)
        err = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
            sorted_leaves(state.params), sorted_leaves(s0.params)))
        check(err <= TRAIN_TWIN_TOL, f"float32 twin: the (2, 1) step "
              f"differs from the plain step by {err}")
        del m0, p0, s0
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return err, same


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _name(path) -> str:
    return "/".join(map(str, path))


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a * b).sum() / (a.norm() * b.norm() + 1e-12))


def _plain_step(cfg, tcfg, batch, dev, leaves) -> dict:
    """One plain step of ``cfg`` (one rank, the whole program, the weights
    of SEED) on ``batch`` -> its loss, and each of ``leaves``' update and
    first moment (b1's share of the gradient) in float32."""
    import gc
    from repro_torch.models.lm import LM
    from repro_torch.train import init_state, make_train_step
    model = LM(cfg, device=dev)
    params = model.init(SEED)
    before = {k: _leaf_at(params, k).clone() for k in leaves}
    state, met = make_train_step(model, tcfg)(init_state(params), batch)
    out = dict(loss=float(met["loss"]),
               delta={k: _leaf_at(state.params, k).float() - before[k].float()
                      for k in leaves},
               m={k: _leaf_at(state.m, k).float() for k in leaves})
    del model, params, state, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _against_plain(state, before, plain, pspecs, mesh) -> dict:
    """Each leaf of ``before`` after one step, its update and first moment
    gathered whole over the mesh (every rank calls it), against
    ``plain``'s (:func:`_plain_step`, rank 0's) -> ``{leaf: {
    "update_cosine", "grad_cosine"}}`` on rank 0, ``{}`` elsewhere."""
    from repro_torch.launch.mesh import gather_params
    out = {}
    for k, b in before.items():
        spec = _leaf_at(pspecs, k)
        whole = gather_params(
            {"p": _leaf_at(state.params, k), "b": b,
             "m": _leaf_at(state.m, k)}, {"p": spec, "b": spec, "m": spec},
            mesh)
        if plain:
            out[_name(k)] = dict(
                update_cosine=_cosine(whole["p"].float() - whole["b"].float(),
                                      plain["delta"][k]),
                grad_cosine=_cosine(whole["m"], plain["m"][k]))
        del whole
    return out


def pod_step_check(cfg, tcfg, mesh211, glob, steps: int,
                   gated=POD_GATED) -> dict:
    """``steps`` int8 pod steps of ``cfg`` over ``(2, 1, 1)``, each pod its
    half of the global batch ``glob``, against one plain step of the
    whole batch on rank 0 (run first, alone): the loss within 1e-3, ``ef``
    nonzero, int8 bytes counted on ``pod``, and each POD_LEAVES leaf's
    update cosine to the plain step's recorded and, for the leaves of
    ``gated``, above UPDATE_COSINE_MIN; the launches of the mesh's steps
    checked against the program."""
    import dataclasses
    import gc
    from repro_torch.models.lm import LM
    from repro_torch.train import init_state, make_train_step
    rank, dev = dist.get_rank(), mesh211.device
    plain = _plain_step(cfg, tcfg, glob, dev, POD_LEAVES) if rank == 0 \
        else None
    dist.barrier()
    model = LM(cfg, mesh=mesh211)
    params = model.init(SEED)
    before = {k: _leaf_at(params, k).clone() for k in POD_LEAVES}
    state = init_state(params, compression=True, mesh=mesh211,
                       pspecs=model.pspecs())
    step = make_train_step(model, dataclasses.replace(
        tcfg, grad_compression="int8"), inplace=True)
    b = glob["tokens"].shape[0] // 2
    batch = {k: v[rank * b:(rank + 1) * b] for k, v in glob.items()}
    state, r = _train_steps(step, state, batch, mesh211, 1)
    ef_nonzero = any(bool((e != 0).any()) for _, e in sorted_leaves(state.ef))
    int8 = r["collectives"].get("ppermute/pod/int8", {}).get("bytes", 0)
    cos = _against_plain(state, before, plain,
                         mesh_pspecs(model, mesh211), mesh211)
    r.update(ef_nonzero=ef_nonzero, int8_bytes_on_pod=int8)
    if rank == 0:
        r.update(plain_loss=plain["loss"],
                 update_cosine={k: c["update_cosine"] for k, c in cos.items()},
                 loss_diff=abs(r["losses"][0] - plain["loss"]))
        check(r["loss_diff"] < 1e-3, f"(2, 1, 1): loss {r['losses'][0]} "
              f"against the plain step's {plain['loss']}")
        low = {k: c for k, c in r["update_cosine"].items()
               if k in map(_name, gated) and not c > UPDATE_COSINE_MIN}
        check(not low, f"(2, 1, 1): the update's cosine to the plain "
              f"step's is not above {UPDATE_COSINE_MIN} on {low}")
    check(ef_nonzero and int8 > 0, f"(2, 1, 1): ef nonzero {ef_nonzero}, "
          f"int8 bytes over pod {int8}")
    del before, plain
    if steps > 1:
        state, later = _train_steps(step, state, batch, mesh211, steps - 1)
        r = _merge(r, later)
    _close(r, "(2, 1, 1)", cfg.num_layers)
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return r


def mesh_pspecs(model, mesh):
    """The model's parameter specs as ``mesh`` lays them out."""
    from repro_torch.launch.mesh import shardings_for
    return shardings_for(mesh, model.pspecs())


def train_meshes(mesh12, res: dict) -> dict:
    """(e): llama3.2-1b at its published widths, bf16, TRAIN_B x
    TRAIN_SEQ tokens a rank, TRAIN_STEPS in-place steps over each of (1,
    2) (all 16 layers), (2, 1) (ZERO_LAYERS) and (2, 1, 1) (POD_LAYERS),
    each mesh's launches and peak memory counted over its own steps
    alone; then the (2, 1, 1) check at the reference test's size and the
    float32 twin of the (2, 1) step (in place against functional), whose
    launches are not the path's."""
    import dataclasses
    import gc
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticLM, init_state, make_train_step
    cfg = _config("llama3.2-1b")
    tcfg = TrainConfig(learning_rate=TRAIN_LR)
    rank = dist.get_rank()
    dev = mesh12.device
    glob = _global_batch(cfg.vocab_size, 2 * TRAIN_B, TRAIN_SEQ, SEED, dev)

    # (1, 2): tensor parallel, vocab-parallel cross entropy; one batch on
    # both ranks, its first step held to the plain step on that batch
    batch = {k: v[:TRAIN_B] for k, v in glob.items()}
    plain = _plain_step(cfg, tcfg, batch, dev, TP_LEAVES) if rank == 0 \
        else None
    dist.barrier()
    model = LM(cfg, mesh=mesh12)
    params = model.init(SEED)
    before = {k: _leaf_at(params, k).clone() for k in TP_LEAVES}
    state = init_state(params, mesh=mesh12, pspecs=model.pspecs())
    step = make_train_step(model, tcfg, inplace=True)
    state, r = _train_steps(step, state, batch, mesh12, 1)
    cos = _against_plain(state, before, plain, mesh_pspecs(model, mesh12),
                         mesh12)
    if rank == 0:
        r.update(plain_loss=plain["loss"], against_plain=cos,
                 loss_diff=abs(r["losses"][0] - plain["loss"]))
        check(r["loss_diff"] <= TP_LOSS_TOL, f"(1, 2): loss "
              f"{r['losses'][0]} against the plain step's {plain['loss']}")
        low = {k: c for k, c in cos.items()
               if not (c["grad_cosine"] >= GRAD_COSINE_MIN
                       and c["update_cosine"] > UPDATE_COSINE_MIN)}
        check(not low, f"(1, 2): the gradient's cosine to the plain step's "
              f"below {GRAD_COSINE_MIN} or the update's not above "
              f"{UPDATE_COSINE_MIN}: {low}")
    del before, plain
    state, later = _train_steps(step, state, batch, mesh12, TRAIN_STEPS - 1)
    r = _close(_merge(r, later), "(1, 2)", cfg.num_layers)
    same = mesh12.all_gather(torch.tensor(r["losses"], device=dev)[None],
                             "model")
    check(bool(torch.isfinite(same).all()) and torch.equal(same[0], same[1]),
          f"(1, 2): losses {same.tolist()} not finite or not equal on ranks")
    res["tp_1x2"] = r
    del model, params, state, step
    gc.collect()
    torch.cuda.empty_cache()

    # (2, 1): ZeRO-1; each rank its half of the global batch, at
    # ZERO_LAYERS of the config's layers
    mesh21 = mesh_mod.make_mesh((2, 1))
    zcfg = dataclasses.replace(cfg, num_layers=ZERO_LAYERS)
    model = LM(zcfg, mesh=mesh21)
    params = model.init(SEED)
    pspecs = model.pspecs()
    state = init_state(params, mesh=mesh21, pspecs=pspecs)
    sliced = sum(1 for (_, p), (_, m) in zip(sorted_leaves(params),
                                             sorted_leaves(state.m))
                 if p.shape != m.shape)
    half = all(m.numel() * 2 == p.numel() or m.shape == p.shape
               for (_, p), (_, m) in zip(sorted_leaves(params),
                                         sorted_leaves(state.m)))
    batch = {k: v[rank * TRAIN_B:(rank + 1) * TRAIN_B]
             for k, v in glob.items()}
    state, r = _train_steps(make_train_step(model, tcfg, inplace=True),
                            state, batch, mesh21, TRAIN_STEPS)
    _close(r, "(2, 1)", zcfg.num_layers)
    sums = mesh21.all_gather(_leaf_sums(state.params)[None], "data")
    r.update(zero_sliced_leaves=sliced,
             leaves=len(sorted_leaves(params)),
             params_equal_on_ranks=bool(torch.equal(sums[0], sums[1])),
             state_bytes_local=sum(t.numel() * 4 for _, t in
                                   sorted_leaves(state.m)) * 2)
    check(sliced > 0 and half, "(2, 1): m/v are not the ZeRO-1 halves")
    check(r["params_equal_on_ranks"], "(2, 1): the ranks' parameters differ "
          "after the all_gather")
    res["zero_2x1"] = r
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()

    # (2, 1, 1): the int8 pod exchange against the plain step on rank 0,
    # at the published widths, then as the reference's own test runs it
    mesh211 = mesh_mod.make_mesh((2, 1, 1), mesh_mod.AXES_3D)
    res["pod_2x1x1"] = pod_step_check(dataclasses.replace(
        cfg, num_layers=POD_LAYERS), tcfg, mesh211, glob, TRAIN_STEPS)
    meshes = ("tp_1x2", "zero_2x1", "pod_2x1x1")
    res["launches"] = {k: sum(res[m]["launches"][k] for m in meshes)
                       for k in res["tp_1x2"]["launches"]}
    res["fnm_shapes"] = {k: sorted(set().union(*(
        map(tuple, res[m]["fnm_shapes"][k]) for m in meshes)))
        for k in res["tp_1x2"]["fnm_shapes"]}
    small = get_config("llama3.2-1b", reduced=True)
    src = SyntheticLM(small.vocab_size, 32, 8).global_batch_at(0)
    # the reference's test holds the first leaf, the embedding
    res["pod_reduced"] = pod_step_check(
        small, tcfg, mesh211,
        {k: torch.from_numpy(v).to(dev) for k, v in src.items()}, 1,
        gated=(("embed",),))

    res["zero_twin_max_abs_err"], res["zero_twin_inplace_equal"] = \
        zero_twin(cfg, tcfg, mesh21)
    return res


# ------------------------------------------------------------ phase 18
# (a): jamba-v0.1-52b, one period, batch 1 at long_500k's length, its
# sequence over data; positions [0, SEQ_FILL) filled, SEQ_NEW decoded
SEQ_MAX, SEQ_FILL, SEQ_NEW = 524288, 524288 - 16, 8
# (b): llama3.2-1b whole at (1, 2) under cache_seq_shard; the last lane's
# 100 positions all lie in rank 0's chunk
SHARD_LANES, SHARD_MAX = 4, 32768
SHARD_LENGTHS = (32760, 20000, 9000, 100)
# (c): the float32 twins, TWIN_LAYERS layers each (the MoE twins at
# TWIN_EXPERTS experts): (key, arch, mesh, replace, max_seq, lengths).
# The decode crosses rank 1's first position (mixtral's rolling window of
# 4096 slots, filled to 524,280, from slot 4088 on rank 1 across the wrap
# to slot 0 on rank 0); SEQ_TWIN_STEPS steps each
SEQ_TWIN_STEPS = 10
SEQ_TWINS = (
    ("jamba-v0.1-52b", "jamba-v0.1-52b", (2, 1), {}, 8192, (4091,)),
    ("llama3.2-1b", "llama3.2-1b", (1, 2), {"cache_seq_shard": True}, 8192,
     (4091, 3000, 8000, 5)),
    ("mixtral-8x22b", "mixtral-8x22b", (2, 1), {}, 4096, (524288 - 8,)),
    ("deepseek-v3-671b", "deepseek-v3-671b", (1, 2),
     {"cache_seq_shard": True}, 8192, (4091, 10)))
# the same at the reduced configs (window 32: max_seq 32, 16 a chunk)
SEQ_TWINS_REDUCED = (
    ("jamba-v0.1-52b", "jamba-v0.1-52b", (2, 1), {}, 32, (11,)),
    ("llama3.2-1b", "llama3.2-1b", (1, 2), {"cache_seq_shard": True}, 32,
     (11, 3, 27, 0)),
    ("mixtral-8x22b", "mixtral-8x22b", (2, 1), {}, 32, (59,)),
    ("deepseek-v3-671b", "deepseek-v3-671b", (1, 2),
     {"cache_seq_shard": True}, 32, (11, 5)),
    ("rwkv6-1.6b", "rwkv6-1.6b", (2, 1), {}, 32, (11,)))


def seeded_cache(model, batch: int, max_seq: int, lengths, seed: int):
    """The rank's share of a decode cache of ``batch`` sequences whose
    leaves are drawn whole from ``seed`` (0.5 x normal, in the leaf's
    dtype, one leaf after another in ``sorted_leaves`` order, a stacked
    leaf one layer after another) and sliced under the leaf's spec,
    ``length`` set to ``lengths``: one global cache on every mesh (and
    without one), of which the rank holds its share.  Positions at or past
    a lane's length are drawn too; the decode masks them.  A rank holds one
    whole layer of one leaf at a time beside its share."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.common import Spec
    tmpl = model.cache_template(batch, max_seq)
    cache = model.init_cache(batch, max_seq)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)

    def local(whole, spec):
        if model.mesh is None:
            return whole
        spec = mesh_mod.shardings_for(model.mesh, spec)
        return whole[mesh_mod.local_index(whole.shape, spec, model.mesh)]

    for (path, c), (_, lf) in zip(sorted_leaves(cache), sorted_leaves(tmpl)):
        if path == ("length",):
            c.copy_(local(torch.tensor(lengths, dtype=torch.int32,
                                       device=model.device), lf.spec))
            continue
        for i in range(lf.shape[0]):  # the stack axis is never split
            whole = torch.randn(lf.shape[1:], generator=gen,
                                device=model.device, dtype=c.dtype) * 0.5
            c[i].copy_(local(whole, Spec(*lf.spec[1:])))
            del whole
    return cache


def _lane(cache, lane: int):
    from repro_torch.models.common import tree_map
    return tree_map(lambda c: c[:, lane] if c.dim() >= 2 else c[lane], cache)


def serve_seq(arch: str, layers, mesh, *, lanes: int, max_seq: int, lengths,
              **replace) -> dict:
    """``arch`` over ``mesh`` through ``Engine(lanes, max_seq)`` with its
    cache's sequence split: random bf16 weights drawn on the card, each
    lane's state from :func:`seeded_cache` taken in by ``Engine.resume``
    (a session whose cache was filled elsewhere, so no prefill), one
    request a lane of SEQ_NEW tokens; every decode_step call timed, row
    5's (S, d, F) recorded, the launch counters and the mesh's counts
    zeroed just before the run and read after; the tokens gathered over
    the mesh must be equal on every rank."""
    import dataclasses
    import gc
    from repro_torch.kernels import ops
    from repro_torch.models.common import count_params, tree_leaves
    from repro_torch.models.lm import LM
    from repro_torch.serve import Engine, Request
    cfg = dataclasses.replace(_config(arch, layers), **replace)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, mesh=mesh)
    params = model.init(SEED)
    torch.cuda.synchronize()
    res = dict(model=arch, layers=cfg.num_layers,
               mesh=list(mesh.shape.values()), max_seq=max_seq,
               lengths=list(lengths), init_s=time.perf_counter() - t0,
               params_local=count_params(params),
               param_bytes_local=sum(t.numel() * t.element_size()
                                     for t in tree_leaves(params)))
    split = model.seq_split(lanes)
    check(split is not None, f"{arch}: the cache's sequence does not split")
    res["seq_axes"] = list(split.axes)
    t0 = time.perf_counter()
    eng = Engine(model, params, lanes=lanes, max_seq=max_seq)
    filled = seeded_cache(model, lanes, max_seq, lengths, SEED + 3)
    res["cache_bytes_local"] = sum(t.numel() * t.element_size()
                                   for t in tree_leaves(eng.cache))
    rng = np.random.default_rng(SEED + 3)
    reqs = [Request(rid=i, prompt=[int(rng.integers(1, cfg.vocab_size))],
                    max_new=SEQ_NEW) for i in range(eng.lanes)]
    for lane, r in enumerate(reqs):
        eng.parked_states[r.rid] = {"state": _lane(filled, lane), "req": r}
        check(eng.resume(r.rid) == lane, f"{arch}: lane {lane} taken")
    del filled
    gc.collect()
    torch.cuda.synchronize()
    res["fill_s"] = time.perf_counter() - t0
    run = _timed_run(eng, mesh, lambda x, w: (
        int(x.shape[0]), int(x.shape[-1]), int(w.shape[-1])))
    launches, stats, shapes = run["launches"], run["stats"], run["shapes"]
    calls = len(run["times"])
    # a lane finishes at max_seq - 1, as the reference's Engine does
    want_new = [min(SEQ_NEW, max_seq - 1 - int(n)) for n in lengths]
    got_new = [len(r.out) for r in reqs]
    check(eng.stats.finished == len(reqs) and got_new == want_new,
          f"{arch}: the lanes generated {got_new} tokens, not {want_new}")
    per_call = fused_per_decode_step(cfg)
    check(launches["fused_norm_matmul"] == per_call * calls,
          f"{arch}: {launches['fused_norm_matmul']} row-5 launches in "
          f"{calls} decode_step calls, not {per_call} a call")
    out = torch.tensor([r.out + [-1] * (SEQ_NEW - len(r.out)) for r in reqs],
                       device=mesh.device)
    every = mesh.all_gather(out[None], ("data", "model"), dim=0)
    res["tokens_equal_on_ranks"] = all(torch.equal(every[0], t)
                                       for t in every)
    check(res["tokens_equal_on_ranks"],
          f"{arch}: the ranks generated different tokens")
    generated = sum(got_new)
    res.update(
        fnm_per_call=per_call, lanes_local=eng.lanes, decode_step_calls=calls,
        generated=got_new, run_s=run["run_s"], **_rates(generated, run),
        row5_shapes=sorted(shapes), launches=launches, collectives=stats,
        collectives_per_call={k: dict(calls=v["calls"] / calls,
                                      bytes=v["bytes"] / calls,
                                      host_ms=v["s"] * 1e3 / calls)
                              for k, v in stats.items()})
    res.update(_profile_decode(model, params, eng.cache))
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del eng, model, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def seq_twin(arch: str, mesh, max_seq: int, lengths, config=None,
             **replace) -> dict:
    """The float32 twin of a split decode: ``arch`` cut as
    :func:`_twin_config` over ``mesh`` (its cache's sequence split) from
    :func:`seeded_cache`, SEQ_TWIN_STEPS decode steps of seeded tokens (all
    the lanes on every rank: the mesh's data axis splits no batch here),
    against the same model and cache unsplit on rank 0, within TWIN_TOL
    and with the same argmax."""
    import gc
    from repro_torch.models.lm import LM, init_params
    cfg = (config or _twin_config)(arch, **replace)
    batch = len(lengths)
    rng = np.random.default_rng(SEED + 4)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (batch, SEQ_TWIN_STEPS))
                            .astype(np.int32)).to(mesh.device)

    def run(model, params):
        cache = seeded_cache(model, batch, max_seq, lengths, SEED + 4)
        outs = []
        with torch.no_grad():
            for i in range(SEQ_TWIN_STEPS):
                logits, cache = model.decode_step(params, toks[:, i:i + 1],
                                                  cache)
                outs.append(logits)
        return outs

    m2 = LM(cfg, mesh=mesh)
    split = m2.seq_split(batch)
    check(split is not None, f"{arch} twin: the cache's sequence does not "
          f"split")
    check(batch == 1 or mesh.axis_size(("pod", "data")) == 1,
          f"{arch} twin: a batch of {batch} over a data axis")
    got = run(m2, init_params(cfg, SEED, dtype=torch.float32, mesh=mesh))
    res = {"layers": cfg.num_layers, "mesh": list(mesh.shape.values()),
           "seq_axes": list(split.axes), "max_seq": max_seq,
           "lengths": list(lengths), "steps": SEQ_TWIN_STEPS}
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        m1 = LM(cfg, tp=m2.tp, device=mesh.device)
        want = run(m1, init_params(cfg, SEED, device=mesh.device,
                                   dtype=torch.float32, tp=m2.tp))
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        res.update(max_abs_err=max(errs), errs=errs, same_argmax=same)
        check(max(errs) <= TWIN_TOL and same,
              f"{arch} split-cache twin: the split decode differs from the "
              f"whole one by {max(errs)} (argmax equal: {same})")
        del m1, want
    del got
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _seq_meshes() -> dict:
    from repro_torch.launch import mesh as mesh_mod
    return {(2, 1): mesh_mod.make_mesh((2, 1)),
            (1, 2): mesh_mod.make_mesh((1, 2))}


def _await_gate() -> None:
    """With ``TP_WORLD_GATE`` set, wait, after the imports and before the
    card or the world is touched, until that file exists (the parent
    starts a world early and releases it later); exit if the parent is
    gone."""
    gate = os.environ.get("TP_WORLD_GATE")
    while gate and not os.path.exists(gate):
        if os.getppid() != _PARENT:
            raise SystemExit("tp_rank: the parent is gone")
        time.sleep(0.1)


def _seq_world(init: str, rank: int, out: str, body, world: int = 2) -> int:
    """Join the world of ``world`` ranks, run ``body(res)``, write ``res``
    (with the error and traceback of a failure, and the wall clock when
    the rank's imports began and ended, when it joined the world and when
    its body ended) to ``out``, after :func:`_await_gate`."""
    imported_at = time.time()
    _await_gate()
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    res = {"started_at": _STARTED, "imported_at": imported_at,
           "joined_at": time.time()}
    t_start = time.perf_counter()
    try:
        body(res)
        res["seconds"] = time.perf_counter() - t_start
        res["ended_at"] = time.time()
    except Exception as e:  # the parent reads it and fails the phase
        import traceback
        res["error"] = f"{type(e).__name__}: {e}"
        res["traceback"] = traceback.format_exc()[-4000:]
        raise
    finally:
        _write(out, res)
        dist.destroy_process_group()
    return 0


def seq(init: str, rank: int, out: str) -> int:
    """Phase 18's world: (a), (b), then the twins (c)."""
    from repro_torch.kernels import ops

    def body(res):
        meshes = _seq_meshes()
        res.update(backend=meshes[(2, 1)].backend, p2p=meshes[(2, 1)].p2p,
                   device=str(meshes[(2, 1)].device))
        launches = {k: 0 for k in ops.LAUNCHES}
        t = time.perf_counter()
        res["long"] = serve_seq("jamba-v0.1-52b", 8, meshes[(2, 1)],
                                lanes=1, max_seq=SEQ_MAX,
                                lengths=(SEQ_FILL,))
        res["long"]["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        res["seqshard"] = serve_seq("llama3.2-1b", None, meshes[(1, 2)],
                                    lanes=SHARD_LANES, max_seq=SHARD_MAX,
                                    lengths=SHARD_LENGTHS,
                                    cache_seq_shard=True)
        res["seqshard"]["seconds"] = time.perf_counter() - t
        for key in ("long", "seqshard"):
            for k, v in res[key]["launches"].items():
                launches[k] += v
        res["launches"] = launches
        t = time.perf_counter()
        res["twins"] = {key: seq_twin(arch, meshes[m], max_seq, lengths,
                                      **replace)
                        for key, arch, m, replace, max_seq, lengths
                        in SEQ_TWINS}
        res["twins"]["seconds"] = time.perf_counter() - t
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    return _seq_world(init, rank, out, body)


def seq_reduced(init: str, rank: int, out: str) -> int:
    """The twins of SEQ_TWINS_REDUCED at the reduced configs in float32:
    the on-card tests' world of the split decodes."""
    import dataclasses
    from repro_torch.configs import get_config

    def small(arch, **replace):
        return dataclasses.replace(get_config(arch, reduced=True),
                                   dtype="float32", **replace)

    def body(res):
        meshes = _seq_meshes()
        res["twins"] = {key: seq_twin(arch, meshes[m], max_seq, lengths,
                                      config=small, **replace)
                        for key, arch, m, replace, max_seq, lengths
                        in SEQ_TWINS_REDUCED}

    return _seq_world(init, rank, out, body)


# ------------------------------------------------------------ phase 20
# llama3.2-1b at its published widths and depth in bf16 over (1, HD_RANKS),
# its gqa cache split over head_dim (8 kv heads do not split over 16): each
# rank holds decode_32k's share of one rank of the reference's (16, 16)
# mesh, HD_LANES lanes of HD_MAX positions at HD_LENGTHS (spread over the
# range), and decodes HD_STEPS greedy steps in place, the first call apart
# (a step is about 10 s of gloo host staging: 4 steps until the whole
# script needed the time)
HD_RANKS = 16
HD_LANES, HD_MAX, HD_STEPS = 8, 32768, 3
HD_LENGTHS = (32760, 28672, 24576, 20480, 16384, 12288, 8192, 4096)
# the float32 twin, cut to TWIN_LAYERS layers (16 took 24 s of the world)
# and HD_TWIN_LANES lanes of HD_TWIN_MAX: rank 0's logits of HD_TWIN_STEPS
# teacher-forced steps, held by the parent to the same model and seeded
# cache at (1, 1) on the card
HD_TWIN_LANES, HD_TWIN_MAX, HD_TWIN_STEPS = 2, 1024, 4
HD_TWIN_LENGTHS = (1000, 37)


def _hd_config(dtype: str = "bfloat16", layers=None):
    import dataclasses
    return dataclasses.replace(_config("llama3.2-1b", layers), dtype=dtype)


def hd_twin_logits(model, params) -> torch.Tensor:
    """The float32 twin's logits (HD_TWIN_STEPS, HD_TWIN_LANES, V) of
    ``model`` (split over a mesh, or whole) from :func:`seeded_cache` and
    seeded teacher-forced tokens."""
    cache = seeded_cache(model, HD_TWIN_LANES, HD_TWIN_MAX, HD_TWIN_LENGTHS,
                         SEED + 6)
    rng = np.random.default_rng(SEED + 6)
    toks = torch.from_numpy(rng.integers(
        1, model.cfg.vocab_size, (HD_TWIN_LANES, HD_TWIN_STEPS))
        .astype(np.int32)).to(model.device)
    outs = []
    with torch.no_grad():
        for i in range(HD_TWIN_STEPS):
            logits, cache = model.decode_step(params, toks[:, i:i + 1],
                                              cache, inplace=True)
            outs.append(logits.float())
    return torch.stack(outs)


def serve_hd(mesh) -> dict:
    """Phase 20's served run on this rank: llama3.2-1b over ``mesh`` with
    random bf16 weights drawn on the card (the rank keeps its shards), the
    rank's share of a seeded cache of HD_LANES lanes of HD_MAX positions
    (its head_dim columns), HD_STEPS greedy decode steps in place, each
    synced and timed, row 5's (S, d, F) recorded, the launch counters and
    the mesh's counts zeroed just before the steps and read after; the
    steps hand back the cache's own tensors, and every rank's tokens are
    equal."""
    import gc
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    cfg = _hd_config()
    tp = mesh.shape["model"]
    check(lm.gqa_cache_split(cfg, tp, False) == "head_dim",
          f"llama3.2-1b's gqa cache does not split head_dim at tp = {tp}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.LM(cfg, mesh=mesh)
    params = model.init(SEED)
    torch.cuda.synchronize()
    res = dict(model="llama3.2-1b", layers=cfg.num_layers,
               mesh=list(mesh.shape.values()), lanes=HD_LANES,
               max_seq=HD_MAX, lengths=list(HD_LENGTHS),
               init_s=time.perf_counter() - t0,
               param_bytes_local=sum(t.numel() * t.element_size()
                                     for t in tree_leaves(params)))
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    cache = seeded_cache(model, HD_LANES, HD_MAX, HD_LENGTHS, SEED + 5)
    torch.cuda.synchronize()
    leaves = [c for _, c in sorted_leaves(cache["stages"])]
    res.update(fill_s=time.perf_counter() - t0,
               cache_bytes_local=sum(c.numel() * c.element_size()
                                     for c in leaves),
               cache_memory_allocated=torch.cuda.memory_allocated() - before,
               k_local_shape=list(cache["stages"][0][0]["mixer"]["k"].shape),
               k_spec=list(model.cache_template(HD_LANES, HD_MAX)[
                   "stages"][0][0]["mixer"]["k"].spec))
    ptrs = [c.data_ptr() for c in leaves]
    del leaves
    rng = np.random.default_rng(SEED + 5)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (HD_LANES, 1))
                              .astype(np.int32)).to(mesh.device)
    times, out = [], []
    with torch.no_grad(), _recorded(mesh, lambda x, w: (
            int(x.shape[0]), int(x.shape[-1]), int(w.shape[-1]))) as rec:
        for _ in range(HD_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = model.decode_step(params, tokens, cache,
                                              inplace=True)
            tokens = torch.argmax(logits, -1).int()[:, None]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            out.append(tokens)
    launches, stats, shapes = rec["launches"], rec["stats"], rec["shapes"]
    check([c.data_ptr() for _, c in sorted_leaves(cache["stages"])] == ptrs,
          "the in-place decode handed back other tensors than the cache's")
    per_call = fused_per_decode_step(cfg)
    check(launches["fused_norm_matmul"] == per_call * HD_STEPS,
          f"{launches['fused_norm_matmul']} row-5 launches in {HD_STEPS} "
          f"decode steps, not {per_call} a step")
    toks = torch.cat(out, dim=1)
    every = mesh.all_gather(toks[None], ("data", "model"), dim=0)
    res["tokens_equal_on_ranks"] = all(torch.equal(every[0], t)
                                       for t in every)
    check(res["tokens_equal_on_ranks"], "the ranks decoded other tokens")
    ms = np.asarray(times) * 1e3
    res.update(
        first_call_ms=float(ms[0]), decode_step_ms=_pcts(ms[1:]),
        step_ms=[float(t) for t in ms],
        tokens_per_s=HD_LANES * (HD_STEPS - 1) / float(np.sum(times[1:])),
        tokens_per_s_with_first=HD_LANES * HD_STEPS / float(np.sum(times)),
        fnm_per_call=per_call, row5_shapes=sorted(shapes),
        launches=launches, collectives=stats,
        collectives_per_call={k: dict(calls=v["calls"] / HD_STEPS,
                                      bytes=v["bytes"] / HD_STEPS,
                                      host_ms=v["s"] * 1e3 / HD_STEPS)
                              for k, v in stats.items()},
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        tokens=toks.tolist())
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return res


def hd(init: str, rank: int, out: str) -> int:
    """Phase 20's world of HD_RANKS ranks at (1, HD_RANKS): the served run
    (:func:`serve_hd`), then the float32 twin split over the same mesh,
    whose logits rank 0 saves beside ``out`` (``.pt``) for the parent."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM, init_params

    def body(res):
        mesh = mesh_mod.make_mesh((1, HD_RANKS))
        res.update(backend=mesh.backend, p2p=mesh.p2p, device=str(mesh.device))
        t = time.perf_counter()
        res["serve"] = serve_hd(mesh)
        res["serve"]["seconds"] = time.perf_counter() - t
        res["launches"] = res["serve"]["launches"]
        t = time.perf_counter()
        cfg = _hd_config("float32", TWIN_LAYERS)
        logits = hd_twin_logits(LM(cfg, mesh=mesh), init_params(
            cfg, SEED, dtype=torch.float32, mesh=mesh))
        if mesh.rank == 0:
            torch.save(logits.cpu(), Path(out).with_suffix(".pt"))
        res["twin"] = dict(layers=TWIN_LAYERS, lanes=HD_TWIN_LANES,
                           max_seq=HD_TWIN_MAX,
                           lengths=list(HD_TWIN_LENGTHS), steps=HD_TWIN_STEPS,
                           seconds=time.perf_counter() - t)
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    return _seq_world(init, rank, out, body, world=HD_RANKS)


def reduced(init: str, rank: int, out: str) -> int:
    """The twins at the configs' reduced sizes (qwen2.5-14b with padded
    heads, the MoE configs with a shared expert; mixtral also with
    ``moe_gather_decode``; llama3.2-1b over (2, 1)), (f), and the float32
    (2, 1) step against the plain step: the on-card tests' world."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo", init_method=f"file://{init}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    global _config

    def small(arch, layers=None):
        cfg = get_config(arch, reduced=True)
        if arch == "qwen2.5-14b":
            cfg = dataclasses.replace(cfg, pad_attn_heads=True)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_shared=1))
        return cfg if layers is None else dataclasses.replace(
            cfg, num_layers=layers)

    _config = small
    res = {}
    try:
        mesh = mesh_mod.make_mesh((1, 2))
        for arch, _ in SERVED:
            res[arch] = twin(arch, mesh)
        res["mixtral-8x22b/gather"] = twin("mixtral-8x22b", mesh,
                                           moe_gather_decode=True)
        res["train_families"] = family_train_twins(mesh)
        mesh21 = mesh_mod.make_mesh((2, 1))
        res["llama3.2-1b/data"] = data_twin("llama3.2-1b", mesh21)
        res["zero_twin_max_abs_err"], res["zero_twin_inplace_equal"] = \
            zero_twin(small("llama3.2-1b"),
                      TrainConfig(learning_rate=TRAIN_LR), mesh21)
    except Exception as e:  # the test reads it
        import traceback
        res["error"] = f"{type(e).__name__}: {e}"
        res["traceback"] = traceback.format_exc()[-4000:]
        raise
    finally:
        _write(out, res)
        dist.destroy_process_group()
    return 0


def main(init: str, rank: int, out: str) -> int:
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    _await_gate()
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo", init_method=f"file://{init}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    res = {}
    t_start = time.perf_counter()
    try:
        mesh = mesh_mod.make_mesh((1, 2))
        res.update(backend=mesh.backend, p2p=mesh.p2p,
                   device=str(mesh.device))
        launches = {k: 0 for k in ops.LAUNCHES}

        def add(counts):
            for k, v in counts.items():
                launches[k] += v

        mesh21 = mesh_mod.make_mesh((2, 1))
        runs = [(arch, arch, layers, mesh, {}) for arch, layers in SERVED]
        runs += [("mixtral-8x22b/gather", "mixtral-8x22b", 4, mesh,
                  {"moe_gather_decode": True}),
                 ("llama3.2-1b/data", "llama3.2-1b", None, mesh21, {})]
        for key, arch, layers, m, replace in runs:
            t = time.perf_counter()
            data = m is mesh21
            res[key] = serve_tp(arch, layers, m, lanes=DATA_LANES if data
                                else LANES, **replace)
            res[key]["twin"] = data_twin(arch, m) if data \
                else twin(arch, m, **replace)
            res[key]["seconds"] = time.perf_counter() - t
            add(res[key]["launches"])
            if "prefill" in res[key]:
                add(res[key]["prefill"]["launches"])
        t = time.perf_counter()
        res["train"] = {}
        train_meshes(mesh, res["train"])
        res["train"]["seconds"] = time.perf_counter() - t
        add(res["train"]["launches"])
        t = time.perf_counter()
        res["train_families"] = family_train_twins(mesh)
        res["train_families"]["seconds"] = time.perf_counter() - t
        add(res["train_families"]["launches"])
        res["launches"] = launches
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        res["seconds"] = time.perf_counter() - t_start
    except Exception as e:  # the parent reads it and fails the phase
        import traceback
        res["error"] = f"{type(e).__name__}: {e}"
        res["traceback"] = traceback.format_exc()[-4000:]
        _write(out, res)
        raise
    finally:
        _write(out, res)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    mode, init, rank, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
        sys.argv[4]
    modes = {"probe": probe, "main": main, "reduced": reduced, "seq": seq,
             "seq_reduced": seq_reduced, "hd": hd}
    if mode not in modes:
        raise SystemExit(f"unknown mode {mode!r}")
    sys.exit(modes[mode](init, rank, out))
