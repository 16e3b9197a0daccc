"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

    python -m pytest -q tests/test_torch_cuda.py   # on the GPU machine

This file imports only ``torch``, ``numpy``, ``pytest`` and ``repro_torch``
(no jax, no ``repro``), so it runs where the port runs.  Every test needs a
card and skips without one.  It holds:

* ``ludo_lookup`` and ``slot_unpack`` bit for bit against their plain
  versions over a port ``OutbackShard``'s CN arrays (batches 1, 1023, 1025,
  4096); ``ludo_lookup`` also at every edge of its plan
  (``ops.ludo_lookup_plan``) on lanes 0-3 elements past a 16-byte
  boundary, its kernel at covering grids of other widths (and a grid
  that does not cover refused), and at large odd
  divisors (ma = 2^31 - 1 over 2^26 words, nb = 2^24 + 1);
  the two wrappers' rejections raised for CUDA tensors as for CPU ones;
* both paged-attention kernels against ``ref.paged_attention_ref`` at the
  shapes of ``tests/test_torch_kernels.py`` and the split pass's edges, to
  1e-5 relative and absolute (both sides in float32, sums in another
  order), and the limits only the CUDA kernels have (head widths 16 and
  32, shared memory, the grid, 16-byte starts) raised for CUDA tensors;
* ``fused_norm_matmul`` against ``ref.fused_norm_matmul_ref`` with TF32 off
  and the tolerances of ``tests/test_kernels.py`` (1e-4 in float32, 3e-2 in
  bf16: the bf16 regimes round x * gamma to bf16 once, 2^-9 relative), at
  the test shapes, llama3.2-1b's serve entries, and the edges of its
  regimes (S = 1, 7, 8, 9, 31, 32, 33, 64 across the row groups and the
  decode / prefill boundary; d = 1000, no multiple of a K-split; F = 1,
  100, 131, 512 and 8192), each call counted once in ``ops.LAUNCHES``, and
  two calls on the same inputs bit for bit alike;
* the CN hot-key cache's device probe and ``observe_batch`` against the
  same cache on the CPU (duplicate and top-bit keys, evictions, the
  negative cache, sketch halving), state for state; a cached shard whose
  batch the cache answers whole launching no index kernel; and a cached
  ``OutbackStore`` driven through a forced §4.4 split (with Gets, inserts
  and deletes inside the window) answering, metering, splitting and
  caching exactly as on the CPU;
* the four baselines (``repro_torch.core.baselines``): each engine's
  ``get_batch`` and ``mn_get_batch`` on the card equal the same engine's on
  the CPU (hits, misses, a miss's value), a mixed stream of mutations with
  an insert batch that raises partway leaves the card's arrays equal to
  the host image and to the CPU engine, ``torch.argmax`` on the card takes
  the first of tied lanes, and the batch approximations (RACE's three
  candidates, MICA's window) miss the same keys on the card as on the CPU;
* the mesh (``repro_torch.core.sharded_kvs``) at (1, 1) in a world whose
  group serves card tensors with NCCL: both variants, with and without a
  CN-cache replica, answer every lane, meter and trace as the gloo mesh
  on the CPU, launching ``ludo_lookup`` and ``slot_unpack`` once a call;
  ``open_store(StoreSpec("sharded"))`` on the card answers, meters and
  re-installs its mesh state as on the CPU;
* the failure plane: every spec of ``tests/_torch_fault_specs.py`` (K=2
  and K=1 crashes, a generated schedule, a partition, ``cn_delay``,
  ``cn_drop``, a cached K=2 store answering degraded, ``outback-dir``
  twins and HRW placement through splits) takes the same stream on the
  card as on the CPU, with the same answers, attribution, meters, traces,
  replica images and plane state; ``ludo_lookup`` and ``slot_unpack``
  launch on the replicated path;
* the telemetry plane and the cluster: a telemetry-on store on the card
  exports the CPU's ``telemetry_rows`` and, against the same store without
  telemetry, the same meters, trace, MN images and launch counts; an N=1
  cluster on the card is identical to ``open_store``; a two-CN cluster
  through a live §4.4 split answers, meters, traces and ends in the CPU's
  state; ``run_chaos(1)`` on the card gives the CPU's report;
* the serving plane: three front-door policies (the dormant pass-through,
  singleflight, admission with a token bucket) push one generated
  two-tenant schedule through a store on the card with the CPU's records,
  stats, lane arrivals, meters, traces, MN images and ``simulate_open``
  replay, launching the index kernels; a ``KVSessionStore`` on the card
  answers a park/resume/shrink/delete stream, meters and ends in the CPU's
  MN images and cache state; the reduced rwkv6 in float32 decodes and
  prefills on the card within 1e-5 of the CPU;
* the training path: ``fused_norm_matmul_bwd`` against
  ``ref.fused_norm_matmul_bwd_ref`` with the forward's tolerances at the
  test shapes, a ragged S and a training entry, counted once a call and
  bit for bit alike twice; each regime of its plan (``wgmma`` with and
  without S-splits and with rows read twice, ``mma`` for ragged F and for
  dy off a 16-byte line, ``fma``) against the plain version, two calls bit
  for bit; a gradient through ``ops.fused_norm_matmul``
  on the card launches both kernels; one float32 ``make_train_step`` step
  of the reduced llama3.2-1b, rwkv6-1.6b, llava-next-mistral-7b,
  mixtral-8x22b and deepseek-v3-671b on the card against the CPU; a
  checkpoint restart on the card replayed bit for bit, for llama3.2-1b
  and for deepseek (whose binned MoE adds nothing with atomics); the
  in-place train step equal to the functional one bit for bit;
* the vlm, MoE and MLA families: the reduced llava, mixtral and deepseek
  in float32 decode (MLA's latent cache, the binned MoE) and prefill
  (llava behind its patches) on the card within 1e-5 of the CPU, with the
  routing indices of every MoE layer equal;
* tensor parallelism: a world of two ranks on the one card
  (``tools/tp_rank.py``, gloo serving card tensors) reduces and gathers
  bf16, float32 and int8 card tensors; ``fused_norm_matmul`` against its
  plain version at the tp = 2 shard shapes of qwen2.5-14b and
  mixtral-8x22b, and it and ``fused_norm_matmul_bwd`` at the tp training
  steps' shapes of llama3.2-1b; and in that world the reduced qwen2.5-14b (padded heads),
  mixtral (a shared expert; also with ``moe_gather_decode``),
  deepseek-v3-671b (MLA), jamba-v0.1-52b (mamba), rwkv6-1.6b and
  whisper-large-v3 (over encoder frames) at tp = 2 against tp = 1
  (prefill and three decode steps in float32, the same routing and bins),
  llama3.2-1b served over (2, 1) against the whole program on the same
  lanes, one float32 (1, 2) train step of each of deepseek, jamba, rwkv6
  and whisper against the plain step, and the (2, 1) ZeRO-1 step against
  the plain step;
* the sequence splits of the decode cache: in a world of two ranks on the
  card (``tools/tp_rank.py seq_reduced``) the reduced llama3.2-1b and
  deepseek-v3-671b (MLA) under ``cache_seq_shard`` at (1, 2), and
  mixtral-8x22b (its rolling window across the wrap), jamba-v0.1-52b and
  rwkv6-1.6b with a batch-1 cache over (2, 1), each from a seeded cache
  whose decode crosses rank 1's first position, against the same model
  and cache unsplit (ten float32 decode steps within 1e-4, the same
  argmax).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import baselines, outback
from repro_torch.core.hashing import lanes, split_u64, splitmix64
from repro_torch.core.store import make_uniform_keys
from repro_torch.kernels import build, ops, ref

pytestmark = pytest.mark.cuda

BATCHES = [1, 1023, 1025, 4096]
PAGED_TOL = dict(rtol=1e-5, atol=1e-5)
FNM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # tests/test_kernels.py:138


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    return torch.cuda.get_device_properties(0).multi_processor_count


# ------------------------------------------------------------- index kernels
def test_kernels_on_card(card):
    """The index kernels bit for bit against their plain versions."""
    keys = make_uniform_keys(40_000)
    shard = outback.OutbackShard(keys, splitmix64(keys), load_factor=0.9,
                                 device="cuda")
    meta = ops.cn_meta_from(shard)
    oth = shard.cn.othello
    wa, wb, seeds = oth.words_a, oth.words_b, shard.cn.seeds
    assert wa.is_cuda and seeds.is_cuda
    for batch in BATCHES:
        lo, hi = (lanes(x, "cuda") for x in split_u64(keys[:batch]))
        got = ops.ludo_lookup(lo, hi, wa, wb, seeds, meta)
        want = ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got = ops.slot_unpack(lo, hi)
        want = ref.slot_unpack_ref(lo, hi)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _ludo_edges(n_sm: int) -> list:
    """Batch sizes at the edges of ``ops.ludo_lookup_plan``: a warp and one
    either side, the serve window and one either side, each block width's
    last batch and the next, a ragged batch past the widest, and 2^20."""
    return sorted({1, 2, 3, 31, 32, 33, 1023, 1024, 1025, 256 * n_sm + 5,
                   1 << 20}
                  | {t * n_sm + d for t in (32, 64, 128, 256)
                     for d in (0, 1)})


def _synthetic_cn(seed, ma, mb, nb):
    """Random Othello words and seeds of the given sizes on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    wa, wb = (torch.randint(-2**31, 2**31, (-(-m // 32),), generator=g,
                            device="cuda", dtype=torch.int32)
              for m in (ma, mb))
    seeds = torch.randint(0, 256, (nb,), generator=g, device="cuda",
                          dtype=torch.uint8)
    meta = dict(ma=ma, mb=mb, nb=nb, seed_a=0x0511AD01, seed_b=0x0B5EED02,
                seed_ba=0xA11CE, seed_bb=0xB0BBE)
    return wa, wb, seeds, meta


def _lanes_at(seed, n, offset):
    """Random key lanes on the card: key_lo ``offset`` elements past a
    16-byte boundary, key_hi wherever its row of the same tensor falls."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    t = torch.randint(-2**31, 2**31, (2, n + 4), generator=g, device="cuda",
                      dtype=torch.int32)
    return t[0, offset:offset + n], t[1, offset:offset + n]


def _same(got, want) -> bool:
    torch.cuda.synchronize()
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def shard_cn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    keys = make_uniform_keys(1 << 16)
    shard = outback.OutbackShard(keys, splitmix64(keys), load_factor=0.95,
                                 device="cuda")
    oth = shard.cn.othello
    return oth.words_a, oth.words_b, shard.cn.seeds, ops.cn_meta_from(shard)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_ludo_lookup_at_the_plan_edges_on_card(card, shard_cn, offset):
    """Every plan edge, on lanes 0-3 elements past a 16-byte boundary."""
    wa, wb, seeds, meta = shard_cn
    for b in _ludo_edges(card):
        lo, hi = _lanes_at(b + offset, b, offset)
        n = ops.LAUNCHES["ludo_lookup"]
        got = ops.ludo_lookup(lo, hi, wa, wb, seeds, meta)
        assert ops.LAUNCHES["ludo_lookup"] == n + 1
        assert all(g.shape == (b,) and g.is_contiguous() for g in got)
        assert _same(got, ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta))


def test_ludo_lookup_kernel_takes_any_covering_grid_on_card(card, shard_cn):
    """Any grid that covers the batch, down to one block, gives the plain
    version's answer at ragged sizes and every offset; a grid that does not cover it is refused before anything
    runs."""
    wa, wb, seeds, meta = shard_cn
    fn = build.launcher("ludo_lookup")
    cn = (wa.data_ptr(), wb.data_ptr(), seeds.data_ptr())
    scalars = (*(ops.ludo_magic(meta[k]) for k in ("ma", "mb", "nb")),
               *(meta[k] & 0xFFFFFFFF for k in ("ma", "mb", "nb", "seed_a",
                                                 "seed_b", "seed_ba",
                                                 "seed_bb")))
    stream = torch.cuda.current_stream().cuda_stream
    for b in (1, 5, 33, 1029, 40_003):
        for offset in range(4):
            lo, hi = _lanes_at(b * 7 + offset, b, offset)
            want = ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta)
            for threads in (32, 64, 256, 1024):
                for blocks in (-(-b // threads), -(-b // threads) + 3):
                    out = torch.full((2, b), -7, dtype=torch.int32,
                                     device="cuda")
                    err = fn(lo.data_ptr(), hi.data_ptr(), *cn,
                             out.data_ptr(), out.data_ptr() + 4 * b, b,
                             *scalars, threads, blocks, stream)
                    assert err == 0
                    assert _same(out, want), (b, offset, threads, blocks)
            if b > 32:
                out = torch.full((2, b), -7, dtype=torch.int32,
                                 device="cuda")
                err = fn(lo.data_ptr(), hi.data_ptr(), *cn, out.data_ptr(),
                         out.data_ptr() + 4 * b, b, *scalars, 32,
                         (b - 1) // 32, stream)
                assert err != 0
                torch.cuda.synchronize()
                assert bool((out == -7).all())


def test_ludo_lookup_at_large_odd_divisors_on_card(card):
    """ma = 2^31 - 1 over 2^26 words (256 MB), mb = 2^30 + 3, and
    nb = 2^24 + 1 seeds: the multiply-high modulos at large odd divisors."""
    wa, wb, seeds, meta = _synthetic_cn(9, 2**31 - 1, 2**30 + 3, 2**24 + 1)
    assert wa.numel() == 1 << 26
    for b in (1, 1025, 1 << 20):
        lo, hi = _lanes_at(b, b, 0)
        got = ops.ludo_lookup(lo, hi, wa, wb, seeds, meta)
        assert _same(got, ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta))
    # keys whose hashes land on the last Othello bits and bucket
    lo = torch.arange(-2**31, -2**31 + 4096, dtype=torch.int32,
                      device="cuda")
    got = ops.ludo_lookup(lo, lo.flip(0).contiguous(), wa, wb, seeds, meta)
    want = ref.ludo_lookup_ref(lo, lo.flip(0).contiguous(), wa, wb, seeds,
                               **meta)
    assert _same(got, want)


def test_index_wrappers_reject_on_card(card, shard_cn):
    """The rejections of tests/test_torch_kernels.py on CUDA tensors, with
    the same exception types, and no launch counted for any of them."""
    wa, wb, seeds, meta = shard_cn
    lo, _ = _lanes_at(1, 64, 0)
    lo = lo.contiguous()
    before = dict(ops.LAUNCHES)
    cases = [
        (TypeError, lambda: ops.ludo_lookup(lo.long(), lo, wa, wb, seeds,
                                            meta)),
        (TypeError, lambda: ops.ludo_lookup(lo, lo, wa, wb, seeds.int(),
                                            meta)),
        (ValueError, lambda: ops.ludo_lookup(lo, lo[:10], wa, wb, seeds,
                                             meta)),
        (ValueError, lambda: ops.ludo_lookup(lo[::2], lo[::2], wa, wb, seeds,
                                             meta)),
        (ValueError, lambda: ops.ludo_lookup(lo, lo, wa[:4], wb, seeds,
                                             meta)),
        (ValueError, lambda: ops.ludo_lookup(lo, lo, wa, wb, seeds[:10],
                                             meta)),
        (ValueError, lambda: ops.ludo_lookup(lo, lo.cpu(), wa, wb, seeds,
                                             meta)),
        (ValueError, lambda: ops.ludo_lookup(lo, lo, wa, wb, seeds,
                                             dict(meta, nb=2**32))),
        (ValueError, lambda: ops.slot_unpack(lo.view(8, 8), lo.view(8, 8))),
        (ValueError, lambda: ops.slot_unpack(lo, lo[:3])),
        (ValueError, lambda: ops.slot_unpack(lo, lo.cpu())),
    ]
    for exc, call in cases:
        with pytest.raises(exc):
            call()
    assert ops.LAUNCHES == before


def test_slot_unpack_rows_on_card(card):
    """One (4, n) output: contiguous rows, bit for bit as the plain
    version, one launch counted."""
    lo, hi = _lanes_at(3, 4099, 1)
    n = ops.LAUNCHES["slot_unpack"]
    got = ops.slot_unpack(lo, hi)
    assert ops.LAUNCHES["slot_unpack"] == n + 1
    assert all(g.shape == (4099,) and g.is_contiguous() for g in got)
    assert _same(got, ref.slot_unpack_ref(lo, hi))


# ----------------------------------------------------------- paged attention
PAGED_SHAPES = [  # n_kv, g, d, ps, L, seq_len, dtype (tests/test_kernels.py)
    (2, 4, 64, 16, 4, 64, "float32"),
    (2, 4, 64, 16, 4, 49, "float32"),  # ragged last page
    (4, 2, 128, 32, 8, 250, "float32"),
    (1, 8, 64, 16, 2, 32, "bfloat16"),
]
# The split pass's edges, for runs of 16 pages (ops.paged_split_plan at
# these sizes on a card of 22 SMs or more): one run; a last run of one
# page; seq_len in the first page of the last run; seq_len in the first
# run, whole runs past it; float32 and d = 128 at L in the hundreds; a
# group of 5 (two query tiles); a ring of 3 loop steps.
PAGED_EDGE_SHAPES = [
    (8, 4, 64, 16, 1, 9, "bfloat16"),
    (8, 4, 64, 16, 321, 321 * 16 - 3, "bfloat16"),
    (8, 4, 64, 16, 320, 19 * 16 * 16 + 5, "bfloat16"),
    (8, 4, 64, 16, 320, 5, "bfloat16"),
    (8, 4, 64, 16, 400, 400 * 16 - 8, "float32"),
    (4, 2, 128, 32, 300, 300 * 32 - 17, "float32"),
    (2, 5, 64, 16, 33, 33 * 16 - 20, "float32"),
    (1, 4, 128, 64, 40, 40 * 64 - 3, "float32"),
]


def _paged_inputs(seed, n_kv, g, d, ps, L, dtype, starts=None):
    """Pools, a Ludo map and a cuckoo map (the first step of every run of
    ``starts`` pages, and step 0, on the unselected candidate) on the
    card."""
    rng = np.random.default_rng(seed)
    pool = 3 * L
    q = rng.standard_normal((n_kv, g, d)).astype(np.float32)
    k = rng.standard_normal((pool, ps, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((pool, ps, n_kv, d)).astype(np.float32)
    pm = rng.choice(pool, L, replace=False).astype(np.int32)
    decoy = rng.choice(pool, L, replace=False).astype(np.int32)
    sel = rng.integers(0, 2, L).astype(np.int32)
    sel[0] = 1
    if starts:
        sel[::starts] = 1
    pm2 = np.where(sel[:, None] == 0, np.stack([pm, decoy], 1),
                   np.stack([decoy, pm], 1)).astype(np.int32)
    q, k, v = (torch.from_numpy(a).to("cuda", getattr(torch, dtype))
               for a in (q, k, v))
    pm, pm2, sel = (torch.from_numpy(a).cuda() for a in (pm, pm2, sel))
    return q, k, v, pm, pm2, sel


def test_paged_kernels_on_card(card):
    """Both paged kernels at the test shapes and the split pass's edges;
    every cuckoo run starts on the unselected candidate."""
    for n_kv, g, d, ps, L, seq_len, dtype in PAGED_SHAPES + PAGED_EDGE_SHAPES:
        split = ops.paged_split_plan(L, n_kv, g, card)[0]
        assert L < 2 or split == 16
        q, k, v, pm, pm2, sel = _paged_inputs(5, n_kv, g, d, ps, L, dtype,
                                              starts=split)
        want = ref.paged_attention_ref(q, k, v, pm, seq_len)
        for got in (ops.paged_attention(q, k, v, pm, seq_len),
                    ops.cuckoo_paged_attention(q, k, v, pm2, sel, seq_len)):
            for g_, w in zip(got, want):
                torch.testing.assert_close(g_, w, **PAGED_TOL)


@pytest.mark.parametrize("d", [16, 32])
def test_paged_kernels_refuse_unbuilt_head_widths_on_card(card, d):
    """The CUDA kernels are built for d = 64 and 128; on CUDA tensors the
    wrappers raise for the widths the plain version takes on the CPU."""
    q, k, v, pm, pm2, sel = _paged_inputs(6, 2, 4, d, 16, 4, "float32")
    n = ops.LAUNCHES["paged_attention"], \
        ops.LAUNCHES["cuckoo_paged_attention"]
    with pytest.raises(ValueError, match="head width"):
        ops.paged_attention(q, k, v, pm, 50)
    with pytest.raises(ValueError, match="head width"):
        ops.cuckoo_paged_attention(q, k, v, pm2, sel, 50)
    assert (ops.LAUNCHES["paged_attention"],
            ops.LAUNCHES["cuckoo_paged_attention"]) == n


def test_paged_kernels_refuse_their_limits_on_card(card):
    """Shared memory, the grid's head blocks and 16-byte starts."""
    pm = torch.zeros(1, dtype=torch.int32, device="cuda")
    q = torch.zeros((1, 4, 128), device="cuda")
    pool = torch.zeros((2, 256, 1, 128), device="cuda")
    with pytest.raises(ValueError, match="shared"):
        ops.paged_attention(q, pool, pool, pm, 1)
    q = torch.zeros((65536, 1, 64), device="cuda")
    pool = torch.zeros((1, 1, 65536, 64), device="cuda")
    with pytest.raises(ValueError, match="grid"):
        ops.paged_attention(q, pool, pool, pm, 1)
    q, k, v, pm, pm2, sel = _paged_inputs(7, 2, 4, 64, 16, 4, "float32")
    shifted = torch.zeros(k.numel() + 1, device="cuda")[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_attention(q, shifted, v, pm, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ops.cuckoo_paged_attention(q, k, shifted, pm2, sel, 64)


# ---------------------------------------------------------- fused norm matmul
FNM_SHAPES = [  # S, d, F, dtype: tests/test_torch_kernels.py's, serve entries
    (256, 512, 1024, "float32"), (512, 256, 512, "float32"),
    (128, 1024, 512, "bfloat16"), (7, 200, 100, "float32"),
    (9, 64, 131, "bfloat16"),
    (8, 2048, 2048, "bfloat16"), (8, 2048, 512, "bfloat16"),
    (8, 2048, 8192, "bfloat16"), (256, 2048, 8192, "bfloat16"),
]
FNM_EDGE_S = (1, 7, 8, 9, 31, 32, 33, 64)
FNM_EDGE_F = (1, 100, 131, 512, 8192)
FNM_EDGE_D = 1000


def _fnm_inputs(seed, S, d, F, dtype):
    """tests/test_kernels.py's inputs (w scaled by 1/sqrt(d)), on the
    card."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((S, d)), rng.standard_normal((d,)),
            rng.standard_normal((d, F)) / np.sqrt(d))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(
        "cuda", getattr(torch, dtype)) for a in arrs)


def _check_fnm(S, d, F, dtype, seed=6):
    x, g, w = _fnm_inputs(seed, S, d, F, dtype)
    n = ops.LAUNCHES["fused_norm_matmul"]
    got = ops.fused_norm_matmul(x, g, w)
    assert ops.LAUNCHES["fused_norm_matmul"] == n + 1
    assert got.dtype == x.dtype and got.shape == (S, F)
    tol = FNM_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               ref.fused_norm_matmul_ref(x, g, w).float(),
                               rtol=tol, atol=tol)
    return x, g, w, got


def test_fused_norm_matmul_on_card(card):
    """The test shapes and llama3.2-1b's decode and prefill entries."""
    for S, d, F, dtype in FNM_SHAPES:
        _check_fnm(S, d, F, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", FNM_EDGE_S)
def test_fused_norm_matmul_regime_edges_on_card(card, S, dtype):
    elt = 4 if dtype == "float32" else 2
    for F in FNM_EDGE_F:
        plan = ops.fused_norm_matmul_plan(S, FNM_EDGE_D, F, elt, card)
        assert (plan["regime"] in ("mma", "stream")) \
            == bool(S <= 32 or F * elt % 16)
        _check_fnm(S, FNM_EDGE_D, F, dtype, seed=S + F)


@pytest.mark.parametrize("S,d,F,dtype", [
    (8, 2048, 8192, "bfloat16"), (8, 2048, 512, "bfloat16"),
    (9, 1000, 131, "bfloat16"), (8, 2048, 2048, "float32"),
    (256, 2048, 8192, "bfloat16"), (64, 1000, 512, "float32")])
def test_fused_norm_matmul_repeats_bit_for_bit_on_card(card, S, d, F, dtype):
    """No atomics: the K-splits add up in a fixed order, so two calls give
    the same bits (each regime: mma, stream, wgmma, fma)."""
    x, g, w, got = _check_fnm(S, d, F, dtype, seed=11)
    for _ in range(3):
        assert torch.equal(ops.fused_norm_matmul(x, g, w), got)


def test_fused_norm_matmul_takes_its_plan_on_card(card):
    """The serve entries on this card: the mma regime, at least as many
    blocks as SMs at F = 8192, and the workspace the plan asks for."""
    for F in (2048, 512, 8192):
        plan = ops.fused_norm_matmul_plan(8, 2048, F, 2, card)
        assert plan["regime"] == "mma"
        assert (plan["splits"] - 1) * plan["krange"] < 2048 \
            <= plan["splits"] * plan["krange"]
    big = ops.fused_norm_matmul_plan(8, 2048, 8192, 2, card)
    assert -(-8192 // big["tile"]) * big["splits"] >= card
    x, g, w = _fnm_inputs(12, 8, 2048, 8192, "bfloat16")
    off = torch.empty(w.numel() + 8, dtype=w.dtype, device="cuda")[1:]
    off[:w.numel()].copy_(w.reshape(-1))
    w_off = off[:w.numel()].view(w.shape)  # 2 bytes past a 16-byte start
    assert ops.fused_norm_matmul_plan(8, 2048, 8192, 2, card, False)[
        "regime"] == "stream"
    torch.testing.assert_close(ops.fused_norm_matmul(x, g, w_off).float(),
                               ops.fused_norm_matmul(x, g, w).float(),
                               rtol=3e-2, atol=3e-2)


# The wgmma regime (bf16, S > 32): both tile widths and clusters, forced
# where the plan would not take them, and a single cluster walking every
# tile (the ring's phases across many tiles): a cluster whose partner row
# tile lies past S (S = 2049, 300; S = 33 with a forced cluster), a ragged
# last column tile (F = 9736, 136; F = 131 takes the stream regime), d off
# 64 (1000, 2568), and the training entries of qwen3-4b (S = 2048, d =
# 2560) and llama3.2-1b (d = 2048), with PR 16's prefill shape.
WGMMA_SHAPES = [(2049, 1000, 1024), (33, 1000, 4096), (2049, 2568, 9736),
                (300, 1000, 9736), (129, 2568, 136), (2049, 1000, 131),
                (300, 1004, 1024), (256, 2048, 8192),
                (2048, 2560, 4096), (2048, 2560, 1024), (2048, 2560, 9728),
                (2048, 2048, 2048), (2048, 2048, 512), (2048, 2048, 8192)]


@pytest.mark.parametrize("S,d,F", WGMMA_SHAPES)
def test_fused_norm_matmul_wgmma_plans_on_card(card, S, d, F):
    """Every tile width, cluster and a one-cluster grid against the plain
    version within 3e-2, each plan's two calls bit for bit alike and alike
    to the plan's own."""
    x, g, w, got = _check_fnm(S, d, F, "bfloat16", seed=S + F)
    plan = ops.fused_norm_matmul_plan(S, d, F, 2, card)
    assert plan["regime"] == ("stream" if F % 8 else "wgmma")
    if plan["regime"] != "wgmma":
        return
    assert torch.equal(ops.fused_norm_matmul(x, g, w), got)
    want = ref.fused_norm_matmul_ref(x, g, w).float()
    for cols in ops.FNM_WGMMA_COLS:
        for cluster in (1, ops.FNM_WGMMA_CLUSTER):
            full = ops.fused_norm_matmul_ctas(S, F, cols, cluster, card)
            # one cluster walks every tile where that takes under a second
            for ctas in (full, cluster) if S * d * F <= 1 << 32 else (full,):
                p = dict(plan, tile=(ops.FNM_WGMMA_ROWS, cols),
                         cluster=cluster, ctas=ctas)
                one = ops._fused_norm_matmul_launch(x, g, w, p)
                two = ops._fused_norm_matmul_launch(x, g, w, p)
                torch.testing.assert_close(one.float(), want, rtol=3e-2,
                                           atol=3e-2)
                # the products are summed as with 128-wide tiles: every
                # plan gives the plan's bits
                assert torch.equal(one, two) and torch.equal(one, got), p


def test_fused_norm_matmul_wgmma_off_16_bytes_on_card(card):
    """x or gamma off a 16-byte boundary: the rows pass reads them element
    by element; the same bits as on aligned copies, two calls alike."""
    S, d, F = 300, 1000, 1024
    x, g, w, aligned = _check_fnm(S, d, F, "bfloat16", seed=21)
    for name in ("x", "gamma"):
        t = x if name == "x" else g
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device="cuda")[1:]
        buf[:t.numel()].copy_(t.reshape(-1))
        off = buf[:t.numel()].view(t.shape)  # 2 bytes past a 16-byte start
        args = (off, g, w) if name == "x" else (x, off, w)
        got = ops.fused_norm_matmul(*args)
        assert torch.equal(got, aligned)
        assert torch.equal(ops.fused_norm_matmul(*args), got)


# --------------------------------------------------- CN cache and the store
def _cache_state_equal(a, b) -> None:
    sa, sb = a.state(), b.state()
    for name in sa:
        if isinstance(sa[name], np.ndarray):
            np.testing.assert_array_equal(sa[name], sb[name], err_msg=name)
        else:
            assert sa[name] == sb[name], name


def test_cn_cache_probe_and_observe_on_card_match_cpu(card):
    from repro_torch.core.cn_cache import CNKeyCache
    caches = [CNKeyCache(4 << 10, device=d) for d in ("cuda", "cpu")]
    low = splitmix64(np.arange(1, 300, dtype=np.uint64)) >> np.uint64(1)
    high = splitmix64(np.arange(1, 300, dtype=np.uint64)
                      + np.uint64(5 << 36)) | np.uint64(1 << 63)
    pool = np.concatenate([low, high])
    rng = np.random.default_rng(0)
    for step in range(12):
        q = pool[rng.integers(0, pool.size, 700)]
        lo, hi = split_u64(q)
        v_lo, v_hi = split_u64(splitmix64(q + np.uint64(step)))
        present = (q % np.uint64(3)) != 0
        outs = []
        for c in caches:
            hit, neg, c_lo, c_hi = c.probe_batch(lo, hi)
            assert hit.device.type == c.device.type
            outs.append([x.cpu() for x in (hit, neg, c_lo, c_hi)])
            c.observe_batch(lo, hi, v_lo, v_hi, present, hit, neg)
        for x, y in zip(*outs):
            assert torch.equal(x, y)
        _cache_state_equal(*caches)
        for c in caches:
            c.note_update_batch(q[:40], q[:40] >> np.uint64(2))
            c.note_delete_batch(q[40:60])
        _cache_state_equal(*caches)
    st = caches[0].stats
    assert st.admitted and st.evicted and st.neg_admitted and st.hits
    assert st.invalidated


def test_cached_shard_on_card_launches_index_kernels_only_on_misses(card):
    from repro_torch.core.cn_cache import CNKeyCache
    keys = make_uniform_keys(4096, 3)
    sh = outback.OutbackShard(keys, splitmix64(keys), device="cuda",
                              cn_cache=CNKeyCache(1 << 16, device="cuda"))
    hot = keys[:64]
    for _ in range(3):
        sh.get_batch(hot)
    ops.reset_launch_counts()
    v_lo, v_hi, match = sh.get_batch(hot)  # every lane hits
    assert bool(match.all())
    assert ops.LAUNCHES["ludo_lookup"] == ops.LAUNCHES["slot_unpack"] == 0
    sh.get_batch(keys[1000:1064])  # misses go to the index
    assert ops.LAUNCHES["ludo_lookup"] >= 1
    assert ops.LAUNCHES["slot_unpack"] >= 1


def _store_run(device):
    from repro_torch.core.store import OutbackStore
    keys = make_uniform_keys(6000, 13)
    vals = splitmix64(keys)
    st = OutbackStore(keys, vals, initial_depth=1, device=device,
                      cn_cache_budget_bytes=32 << 10)
    rng = np.random.default_rng(4)
    fresh = splitmix64(np.arange(1, 900, dtype=np.uint64)
                       + np.uint64(21 << 40))
    out = []
    for _ in range(3):
        out.append([x.cpu() for x in st.get_batch(
            keys[rng.integers(0, 800, 512)])])
    out.append(st.update_batch(keys[:64], keys[:64] >> np.uint64(1)))
    h = st.begin_split(0)
    out.append(st.insert_batch(fresh[:300], fresh[:300]))
    out.append(st.delete_batch(keys[100:140]))
    out.append(st.update_batch(keys[:32], keys[:32]))
    out.append([x.cpu() for x in st.get_batch(keys[:700])])
    h.build()
    h.finish()
    out.append(st.insert_batch(fresh[300:], fresh[300:]))
    out.append([x.cpu() for x in st.get_batch(
        np.concatenate([keys[:800], fresh]), resolve_makeup=True)])
    events = [(e.step, e.table_keys, e.locator_bytes, e.buffered_mutations)
              for e in st.resize_events]
    return st, out, events


def test_store_forced_split_on_card_matches_cpu(card):
    (g, g_out, g_ev), (c, c_out, c_ev) = _store_run("cuda"), _store_run("cpu")
    assert g.tables[0].slots_lo.is_cuda and g.cn_cache.k_lo.is_cuda
    assert len(g_out) == len(c_out)
    for a, b in zip(g_out, c_out):
        if isinstance(a, list) and a and isinstance(a[0], torch.Tensor):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert g_ev == c_ev and g_ev
    assert g.meter_total().snapshot() == c.meter_total().snapshot()
    assert (g.directory, g.local_depth, g.global_depth) == \
        (c.directory, c.local_depth, c.global_depth)
    for a, b in zip(g.tables, c.tables):
        sa, sb = a.mn_state(), b.mn_state()
        for k in sa:
            if k != "overflow":
                np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    _cache_state_equal(g.cn_cache, c.cn_cache)
    assert g.cn_cache.stats.invalidated > 0


# ------------------------------------------------------------------ baselines
BASELINES = ["RaceKVS", "MicaKVS", "ClusterKVS", "DummyKVS"]


def _batch_host(out):
    return [x.cpu() for x in out]


def _absent(n):
    return splitmix64(np.arange(1, n + 1, dtype=np.uint64)
                      + np.uint64(1 << 45))


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_gets_on_card_match_cpu(card, name):
    keys = make_uniform_keys(50_000, 13)
    vals = splitmix64(keys)
    g = getattr(baselines, name)(keys, vals, device="cuda")
    c = getattr(baselines, name)(keys, vals, device="cpu")
    assert all(x.is_cuda for x in g.mn_arrays())
    for q in (keys[:1], keys[:1023], np.concatenate([keys, _absent(4096)])):
        for a, b in zip(_batch_host(g.get_batch(q)), c.get_batch(q)):
            assert torch.equal(a, b)
    assert g.meter.snapshot() == c.meter.snapshot()
    if name in ("MicaKVS", "ClusterKVS"):
        q = np.concatenate([keys[:65536], _absent(512)])
        got = g.mn_get_batch(*g.query(q), g.mn_arrays())
        want = c.mn_get_batch(*c.query(q), c.mn_arrays())
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    if name == "DummyKVS":
        idx = torch.arange(-5, 5000, dtype=torch.int32)
        got = g.mn_get_batch(idx.cuda(), g.mn_arrays())
        want = c.mn_get_batch(idx, c.mn_arrays())
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", ["RaceKVS", "MicaKVS", "ClusterKVS"])
def test_baseline_mutations_on_card_keep_the_mirror(card, name):
    """A mixed stream, then an insert batch that raises partway: the
    card's arrays equal the host image and the CPU engine's."""
    keys = make_uniform_keys(2048, 7)
    vals = splitmix64(keys)
    g = getattr(baselines, name)(keys, vals, device="cuda")
    c = getattr(baselines, name)(keys, vals, device="cpu")
    fresh = splitmix64(np.arange(1, 4001, dtype=np.uint64)
                       + np.uint64(3 << 44))
    for kvs in (g, c):
        kvs.update_batch(keys[:300], keys[:300])
        kvs.delete_batch(keys[300:400])
        kvs.insert_batch(fresh[:64], fresh[:64])
        kvs.update(int(keys[5]), 5)
        kvs.delete(int(keys[6]))
    errs = []
    for kvs in (g, c):
        with pytest.raises(RuntimeError) as e:
            kvs.insert_batch(fresh[64:], fresh[64:])
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert g.meter.snapshot() == c.meter.snapshot()
    host, dev, cpu = g.host_image(), g.device_image(), c.host_image()
    for k in host:
        np.testing.assert_array_equal(dev[k], host[k], err_msg=k)
        np.testing.assert_array_equal(host[k], cpu[k], err_msg=k)
    assert g.t_klo.shape[0] == g.h_klo.shape[0] > keys.size  # heap grew
    q = np.concatenate([keys[:500], fresh[:200], _absent(64)])
    for a, b in zip(_batch_host(g.get_batch(q)), c.get_batch(q)):
        assert torch.equal(a, b)


def test_argmax_takes_the_first_tied_lane_on_card(card):
    x = torch.zeros((4096, 32), dtype=torch.uint8)
    rng = np.random.default_rng(1)
    for r in range(4096):
        x[r, rng.choice(32, size=int(rng.integers(0, 6)), replace=False)] = 1
    want = torch.tensor([int(np.argmax(row)) for row in x.numpy()])
    assert torch.equal(torch.argmax(x.cuda(), 1).cpu(), want)
    assert torch.equal(torch.argmax(x, 1), want)


def test_baseline_batch_approximations_on_card(card):
    """RACE's three candidates and MICA's four-bucket window miss the same
    keys on the card as on the CPU (and ``get`` finds them)."""
    cand = splitmix64(np.arange(1, 1 << 16, dtype=np.uint64)
                      + np.uint64(3 << 40))
    race_keys = cand[baselines.RaceKVS._fp(*split_u64(cand)) == 7][:8]
    cases = [("RaceKVS", race_keys, {}),
             ("MicaKVS", make_uniform_keys(2048, 7), dict(load_factor=0.95))]
    for name, keys, kw in cases:
        vals = splitmix64(keys)
        g = getattr(baselines, name)(keys, vals, device="cuda", **kw)
        c = getattr(baselines, name)(keys, vals, device="cpu", **kw)
        got = _batch_host(g.get_batch(keys))
        for a, b in zip(got, c.get_batch(keys)):
            assert torch.equal(a, b)
        miss = ~got[2].numpy()
        assert miss.any(), name
        for i in np.nonzero(miss)[0]:
            assert g.get(int(keys[i])) == int(vals[i])


# ------------------------------------------------------- the mesh, (1, 1)
@pytest.fixture
def nccl_world(card, tmp_path):
    """A one-rank world whose group serves CPU tensors with gloo and card
    tensors with NCCL, destroyed after the test."""
    import torch.distributed as dist
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_run(device, variant, cached, keys, vals, q):
    """One (1, 1) mesh Get of ``q`` on ``device`` with a transport (and a
    warmed CN-cache replica): outputs, meter, trace, index launches."""
    import dataclasses
    from _torch_mesh_rank import warm_cache
    from repro_torch.core import sharded_kvs as skv
    from repro_torch.core.cn_cache import CNKeyCache, ShardedCNCache
    from repro_torch.net import Transport
    mesh = skv.make_mesh((1, 1), device=device)
    tr = Transport()
    st = skv.build_sharded(keys, vals, num_shards=1, data_parallel=1,
                           transport=tr)
    extra, cache = (), None
    if cached:
        warm = keys[np.random.default_rng(2).zipf(1.5, 4096) % keys.size]
        host = warm_cache(CNKeyCache(1 << 16, device=device), warm,
                          splitmix64(warm))
        cache = ShardedCNCache(host, 1)
        extra = skv.place_cache(mesh, cache)
    blocks = skv.place_state(mesh, st)
    assert all(b.device.type == device for b in blocks + extra)
    fn, _ = skv.make_get_fn(mesh, st, q.size, variant=variant, cache=cache)
    lo, hi = (lanes(x, mesh.device) for x in split_u64(q))
    ops.reset_launch_counts()
    out = fn(lo, hi, *extra, *blocks)
    launches = dict(ops.LAUNCHES)
    return ([x.cpu() for x in out], st.meter.snapshot(),
            [(type(e).__name__, dataclasses.astuple(e)) for e in tr.trace],
            launches)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("variant", ["outback", "race"])
def test_mesh_get_on_card_matches_cpu(nccl_world, variant, cached):
    """The (1, 1) NCCL mesh on the card answers every lane (hits, misses,
    sentinel and absent keys), meters and traces as the gloo mesh on the
    CPU, through the ``ludo_lookup`` and ``slot_unpack`` kernels."""
    keys = make_uniform_keys(20_000, 4)
    vals = splitmix64(keys)
    q = keys[np.random.default_rng(6).zipf(1.3, 4096) % keys.size]
    q[5:9] = splitmix64(np.arange(4, dtype=np.uint64) + np.uint64(77 << 40))
    q[0] = q[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    card_run = _mesh_run("cuda", variant, cached, keys, vals, q)
    cpu_run = _mesh_run("cpu", variant, cached, keys, vals, q)
    for a, b in zip(card_run[0], cpu_run[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert card_run[1:3] == cpu_run[1:3]
    assert card_run[3]["ludo_lookup"] == card_run[3]["slot_unpack"] == 1
    assert not any(cpu_run[3].values())
    match = card_run[0][2].numpy()
    assert match[9:-1].all() and not match[5:9].any()
    if cached:
        assert card_run[0][3].sum() > 0


def test_sharded_store_on_card_matches_cpu(card):
    """``open_store(StoreSpec("sharded"))`` on the card: answers, meters and
    the re-installed mesh state equal the CPU's after mutations."""
    from repro_torch.api import StoreSpec, open_store
    keys = make_uniform_keys(4096, 8)
    vals = splitmix64(keys)
    fresh = splitmix64(np.arange(1, 300, dtype=np.uint64)
                       + np.uint64(5 << 42))
    runs = []
    for device in ("cuda", "cpu"):
        st = open_store(StoreSpec("sharded", params={"num_shards": 2}),
                        keys, vals, device=device)
        assert {sh.device.type for sh in st.engine.shards} == {device}
        out = [st.insert_batch(fresh, fresh), st.update_batch(keys[:99],
                                                              keys[:99]),
               st.delete_batch(keys[99:150]), st.insert(int(keys[99]), 3),
               st.get_batch(np.concatenate([keys, fresh]))]
        runs.append(([(r.values.tolist(), r.found.tolist(), r.statuses)
                      for r in out], st.meter_totals().snapshot(),
                     [a.copy() for a in st.mesh_state().arrays()]))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2], runs[1][2]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ failure plane
@pytest.mark.parametrize("name", ["k2_crash", "k1_crash", "generated",
                                  "partition", "cn_delay", "cn_drop",
                                  "k2_cache", "dir_twins", "dir_late",
                                  "dir_hrw"])
def test_failure_plane_on_card_matches_cpu(card, name):
    """One seeded stream through a replicated, faulted store on the card
    and on the CPU: every answer, attribution, meter, trace, replica image
    and the plane's state equal; the index kernels launch on the card."""
    import dataclasses

    from _torch_fault_specs import (SPECS, drive, fault_data, fault_stream,
                                    replica_set, state_sig)
    from repro_torch.api import open_store
    from repro_torch.net import Transport
    spec, shape = SPECS[name]
    data = fault_data()
    calls = fault_stream(data, shape)
    runs = []
    for device in ("cuda", "cpu"):
        ops.reset_launch_counts()
        tr = Transport()
        st = open_store(spec, data[0], data[1], device=device, transport=tr)
        out = drive(st, calls, False)
        launches = dict(ops.LAUNCHES)
        rs = replica_set(st)
        assert {r.engine.device.type for r in rs.replicas} == {device}
        runs.append((out, st.meter_totals().snapshot(),
                     [(type(e).__name__, dataclasses.astuple(e))
                      for e in tr.trace],
                     [state_sig(r.engine.mn_state()) for r in rs.replicas],
                     (rs.primary, sorted(rs._needs_resync), rs.plane.clock)))
        if device == "cuda":
            assert launches["ludo_lookup"] > 0 and launches["slot_unpack"] > 0
        else:
            assert not any(launches.values())
    for a, b in zip(runs[0], runs[1]):
        assert a == b



# ------------------------------------------------- telemetry plane, cluster
def _tuples(trace):
    import dataclasses
    return [(type(e).__name__, dataclasses.astuple(e)) for e in trace]


def _obs_run(spec, keys, vals, device, stream):
    import json
    import pickle

    from repro_torch.api import open_store
    from repro_torch.net import Transport
    from repro_torch.obs import telemetry_rows
    ops.reset_launch_counts()
    tr = Transport()
    st = open_store(spec, keys, vals, device=device, transport=tr)
    out = []
    for op, ks, vs in stream:
        r = (st.get_batch(ks) if op == "get" else
             st.update_batch(ks, vs) if op == "update" else
             st.insert_batch(ks, vs) if op == "insert" else
             st.delete_batch(ks))
        out.append((r.values.tolist(), r.found.tolist(), r.statuses))
    st.flush()
    adapter = st
    while hasattr(adapter, "inner"):
        adapter = adapter.inner
    engines = ([r.engine for r in adapter.replicas]
               if hasattr(adapter, "replicas") else [adapter.engine])
    rows = (None if st.telemetry is None
            else [json.dumps(r, sort_keys=True)
                  for r in telemetry_rows(st.telemetry)])
    return dict(out=out, meter=st.meter_totals().snapshot(),
                trace=_tuples(tr.trace), launches=dict(ops.LAUNCHES),
                images=pickle.dumps([e.mn_state() for e in engines]),
                rows=rows)


@pytest.mark.parametrize("kind", ["outback", "outback-dir", "k2_crash"])
def test_telemetry_hub_on_card_is_a_pure_observer(card, kind):
    """A telemetry-on store on the card exports the CPU's rows, and the
    hub leaves its answers, meters, trace, MN images and launch counts as
    a telemetry-off store on the card has them."""
    from repro_torch.api import BatchPolicy, StoreSpec, TelemetryConfig
    from repro_torch.net import FaultSchedule
    keys = make_uniform_keys(4096, 5)
    vals = splitmix64(keys)
    # enough inserts to split the directory store; a plain shard's
    # overflow cache takes a few
    fresh = make_uniform_keys(5120, 6)[:512 if kind == "outback-dir" else 32]
    kw = dict(load_factor=0.85, batch=BatchPolicy(window=64),
              telemetry=TelemetryConfig(window_ops=128))
    if kind == "k2_crash":
        kw.update(replicas=2, faults=FaultSchedule.single_crash(
            at_op=512, duration_ops=512, lease_term_ops=64))
    if kind == "outback-dir":
        kw.update(cache_budget_bytes=16 << 10, params={"initial_depth": 1})
    spec = StoreSpec("outback" if kind == "k2_crash" else kind, **kw)
    off = StoreSpec.from_json_dict({**spec.to_json_dict(),
                                    "telemetry": None})
    rng = np.random.default_rng(3)
    stream = [("get", keys[rng.integers(0, 4096, 128)], None)
              for _ in range(12)]
    stream += [("update", keys[:64], keys[:64]),
               ("insert", fresh, fresh), ("delete", keys[64:96], None),
               ("get", keys[:256], None)]
    on = _obs_run(spec, keys, vals, "cuda", stream)
    cpu = _obs_run(spec, keys, vals, "cpu", stream)
    dormant = _obs_run(off, keys, vals, "cuda", stream)
    assert on["rows"] == cpu["rows"]
    for k in ("out", "meter", "trace", "images"):
        assert on[k] == cpu[k] == dormant[k], k
    assert on["launches"] == dormant["launches"]
    assert on["launches"]["ludo_lookup"] > 0
    assert not any(cpu["launches"].values())


def test_single_cn_cluster_on_card_matches_open_store(card):
    from repro_torch.api import StoreSpec, open_store
    from repro_torch.cluster import cluster_of
    from repro_torch.net import Transport
    from repro_torch.net.chaos import state_signature
    keys = make_uniform_keys(4096, 9)
    vals = splitmix64(keys)
    spec = StoreSpec("outback-dir", cache_budget_bytes=16 << 10)
    t_ref = Transport()
    ref = open_store(spec, keys, vals, device="cuda", transport=t_ref)
    cl = cluster_of(spec, keys, vals, n_cns=1, device="cuda")
    rng = np.random.default_rng(0)
    for step in range(6):
        idx = rng.integers(0, 4096, 256)
        a, b = ref.get_batch(keys[idx]), cl.cns[0].get_batch(keys[idx])
        assert a.values.tolist() == b.values.tolist()
        if step % 2:
            nv = rng.integers(1, 1 << 32, 64).astype(np.uint64)
            ref.update_batch(keys[idx[:64]], nv)
            cl.cns[0].update_batch(keys[idx[:64]], nv)
    assert ref.meter_totals().snapshot() == cl.meter_totals().snapshot()
    assert t_ref.trace == cl.transports[0].trace
    assert state_signature(ref.engine.mn_state()) == \
        state_signature(cl.mn_state())
    assert cl.stats.forward_rpcs == 0 and cl.stats.handoffs == 0


def test_two_cn_cluster_through_a_split_on_card_matches_cpu(card):
    """Two CNs interleave reads and writes through a live §4.4 split: the
    card's answers, meters, traces, stats and final MN state are the
    CPU's, and the shared pool's Gets launch the index kernels."""
    from repro_torch.api import StoreSpec
    from repro_torch.cluster import cluster_of
    from repro_torch.net.chaos import state_signature
    rng0 = np.random.default_rng(9)
    keys = np.unique(rng0.integers(1, 1 << 62, 4608, dtype=np.uint64))
    base, extra = keys[:2048], keys[2048:4096]
    runs = []
    for device in ("cuda", "cpu"):
        ops.reset_launch_counts()
        cl = cluster_of(StoreSpec("outback-dir", load_factor=0.85,
                                  cache_budget_bytes=32 << 10),
                        base, base, n_cns=2, device=device)
        rng = np.random.default_rng(42)
        out = []
        for step in range(24):
            w, r = cl.cns[step % 2], cl.cns[(step + 1) % 2]
            idx = rng.integers(0, 2048, 96)
            out.append(r.get_batch(base[idx]).values.tolist())
            nv = rng.integers(1, 1 << 32, 32).astype(np.uint64)
            out.append(w.update_batch(base[idx[:32]], nv).found.tolist())
            out.append(w.insert_batch(extra[step * 64:(step + 1) * 64],
                                      extra[step * 64:(step + 1) * 64]
                                      ).found.tolist())
            out.append(r.get_batch(base[idx]).values.tolist())
        launches = dict(ops.LAUNCHES)
        assert len(cl.engine.tables) > 1, "the run must split a table"
        runs.append((out, cl.meter_totals().snapshot(),
                     [_tuples(t.trace) for t in cl.transports],
                     cl.stats.snapshot(), state_signature(cl.mn_state())))
        if device == "cuda":
            assert launches["ludo_lookup"] > 0 and launches["slot_unpack"] > 0
    assert runs[0] == runs[1]


def test_chaos_on_card_matches_cpu(card):
    from repro_torch.net.chaos import run_chaos
    a = run_chaos(1, telemetry=True, device="cuda")
    b = run_chaos(1, telemetry=True, device="cpu")
    assert a.passed and a.to_json_dict() == b.to_json_dict()


# ------------------------------------------------------------ serving plane
def _frontdoor_runs(device: str) -> list:
    """One generated two-tenant schedule through three front-door policies
    over a fresh 8000-key store each, with a transport; everything a run
    leaves behind, in plain values."""
    import dataclasses
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.net import Transport
    from repro_torch.net.chaos import state_signature
    from repro_torch.net.replay import simulate_open
    from repro_torch.serve import (FrontDoor, FrontDoorConfig, TenantLimit,
                                   TenantSpec, TrafficSpec, generate)
    keys = make_uniform_keys(8000, 3)
    vals = splitmix64(keys)
    spec = TrafficSpec(tenants=(
        TenantSpec("a", 3e5, read_frac=0.7, insert_frac=0.05, keyspace=256),
        TenantSpec("b", 2e5, read_frac=0.5, zipf_theta=0.9, hot_salt=2)),
        duration_s=0.004, seed=7)
    offered = generate(spec, keys)
    out = []
    for cfg in (FrontDoorConfig(),
                FrontDoorConfig(singleflight=True, window=64),
                FrontDoorConfig(max_inflight=4, queue_depth=8, service_us=16.0,
                                singleflight=True, window=128,
                                limits=(TenantLimit("b", 5e4, burst=4.0),))):
        tr = Transport()
        st = open_store(StoreSpec("outback", load_factor=0.85,
                                  batch=BatchPolicy(window=256)),
                        keys, vals, device=device, transport=tr)
        fd = FrontDoor(st, cfg)
        recs = fd.run(offered)
        sim = simulate_open(tr.trace, np.asarray(fd.lane_arrivals()))
        out.append(([dataclasses.astuple(r) for r in recs], fd.stats(),
                    fd.lane_arrivals(), st.meter_totals().snapshot(),
                    _tuples(tr.trace), state_signature(st.engine.mn_state()),
                    np.asarray(sim.lat_by_op_us).tolist(),
                    np.asarray(sim.completions_by_op_s).tolist()))
    return out


def test_frontdoor_on_card_matches_cpu(card):
    ops.reset_launch_counts()
    on_card = _frontdoor_runs("cuda")
    launches = dict(ops.LAUNCHES)
    assert on_card == _frontdoor_runs("cpu")
    assert launches["ludo_lookup"] > 0 and launches["slot_unpack"] > 0
    assert {o for run in on_card for o in (r[5] for r in run[0])} >= \
        {"ok", "collapsed", "shed", "ratelimited"}


def test_session_store_round_trip_on_card_matches_cpu(card):
    from repro_torch.net.chaos import state_signature
    from repro_torch.serve import KVSessionStore
    rng = np.random.default_rng(4)
    blobs = {rid: rng.bytes(n) for rid, n in
             enumerate((0, 7, 8, 4093, 1 << 16, 3 * (1 << 14) + 5))}
    runs = []
    for device in ("cuda", "cpu"):
        ss = KVSessionStore(cn_cache_budget_bytes=64 << 10, device=device)
        out = []
        for rid, blob in blobs.items():
            out.append(ss.put(rid, blob))
        out += [ss.get(rid) == blob for rid, blob in blobs.items()]
        out += [ss.get(rid) == blob for rid, blob in blobs.items()]
        out += [ss.put(4, b"short"), ss.get(4), ss.delete(2), ss.get(2),
                ss.get(99), ss.delete(2)]
        if device == "cuda":
            assert all(t.slots_lo.is_cuda for t in ss.store.engine.tables)
        state = ss.store.cache.state()
        runs.append((out, ss.meter_total().snapshot(),
                     state_signature(ss.store.engine.mn_state()),
                     {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                      for k, v in state.items()}))
    assert runs[0] == runs[1]
    assert runs[0][3]["stats"]["hits"] > 0


def test_rwkv_decode_on_card_matches_cpu(card):
    """The reduced rwkv6 in float32 from the same weights: 6 decode steps
    (logits and every cache leaf) and a 32-token prefill, card against
    CPU, within 1e-5 (both in float32, sums in another order)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.common import sorted_leaves, tree_map
    from repro_torch.models.lm import LM, init_params
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", reduced=True),
                              dtype="float32")
    p_cpu = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    p_gpu = tree_map(lambda t: t.to("cuda"), p_cpu)
    models = {"cpu": LM(cfg, device="cpu"), "cuda": LM(cfg, device="cuda")}
    caches = {d: m.init_cache(3, 16) for d, m in models.items()}
    params = {"cpu": p_cpu, "cuda": p_gpu}
    rng = np.random.default_rng(1)
    tol = dict(rtol=1e-5, atol=1e-5)
    for _ in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))
                               .astype(np.int32))
        logits = {}
        for d, m in models.items():
            logits[d], caches[d] = m.decode_step(params[d], tok.to(d),
                                                 caches[d])
        torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"], **tol)
    for (_, g), (_, w) in zip(sorted_leaves(caches["cuda"]),
                              sorted_leaves(caches["cpu"])):
        torch.testing.assert_close(g.cpu(), w, **tol)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                            .astype(np.int32))
    got = models["cuda"].prefill(p_gpu, {"tokens": toks.to("cuda")})
    want = models["cpu"].prefill(p_cpu, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "mixtral-8x22b",
                                  "deepseek-v3-671b", "jamba-v0.1-52b",
                                  "whisper-large-v3"])
def test_family_decode_on_card_matches_cpu(card, arch):
    """The reduced config in float32 from the same weights: 6 decode steps
    (logits and every cache leaf: jamba's mamba state and conv tail;
    whisper on its zero encoder stub) and a 24-token prefill (behind the
    config's patch embeddings for llava; over seeded frames for whisper,
    so its encoder runs), card against CPU, within 1e-5 (jamba's caches
    1e-4: its float32 mamba state carries the two libraries' last-bit
    differences of ``exp`` and ``log1p`` into the next steps' attention
    cache, 1.4e-5 on one of 1536 values measured); the MoE router picks
    the same experts on both at every layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import sorted_leaves, tree_map
    from repro_torch.models.lm import LM, init_params
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    p_cpu = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    params = {"cpu": p_cpu, "cuda": tree_map(lambda t: t.to("cuda"), p_cpu)}
    models = {d: LM(cfg, device=d) for d in params}
    caches = {d: m.init_cache(3, 16) for d, m in models.items()}
    picks = {"cpu": [], "cuda": []}
    route = moe.router_probs

    def spy(p, x, c):
        out = route(p, x, c)
        picks[x.device.type].append(out[1].cpu())
        return out

    rng = np.random.default_rng(1)
    tol = dict(rtol=1e-5, atol=1e-5)
    moe.router_probs = spy
    try:
        for _ in range(6):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))
                                   .astype(np.int32))
            logits = {d: None for d in models}
            for d, m in models.items():
                logits[d], caches[d] = m.decode_step(params[d], tok.to(d),
                                                     caches[d])
            torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"],
                                       **tol)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 24)).astype(np.int32))}
        for name, n in (("patches", cfg.vision_tokens),
                        ("frames", cfg.encoder_seq if cfg.is_encdec else 0)):
            if n:
                batch[name] = torch.from_numpy(rng.standard_normal(
                    (2, n, cfg.d_model)).astype(np.float32))
        got = models["cuda"].prefill(params["cuda"], {
            k: v.to("cuda") for k, v in batch.items()})
        want = models["cpu"].prefill(params["cpu"], batch)
    finally:
        moe.router_probs = route
    torch.testing.assert_close(got.cpu(), want, **tol)
    cache_tol = dict(rtol=1e-4, atol=1e-4) if cfg.family == "hybrid" \
        else tol
    for (_, g), (_, w) in zip(sorted_leaves(caches["cuda"]),
                              sorted_leaves(caches["cpu"])):
        torch.testing.assert_close(g.cpu(), w, **cache_tol)
    assert len(picks["cuda"]) == len(picks["cpu"])
    assert (len(picks["cpu"]) > 0) == (cfg.moe is not None)
    for a, b in zip(picks["cuda"], picks["cpu"]):
        assert torch.equal(a, b)


# ------------------------------------------------------ the training path
# the rows of a tp training step of llama3.2-1b (2 x 512 a rank) at its q,
# k / v and gate / up columns, split at tp = 2 and whole (ZeRO-1, pods)
TP_TRAIN_SHAPES = [(1024, 2048, F) for F in (1024, 256, 4096, 2048, 512,
                                               8192)]
FNMB_SHAPES = [  # tests/test_torch_kernels.py's, a ragged S, a training
    # entry, the tp training steps' shapes
    (256, 512, 1024, "float32"), (512, 256, 512, "float32"),
    (128, 1024, 512, "bfloat16"), (7, 200, 100, "float32"),
    (9, 64, 131, "bfloat16"), (7, 2048, 1000, "bfloat16"),
    (2048, 2048, 512, "bfloat16"), (2048, 2048, 512, "float32"),
    *[(*sh, "bfloat16") for sh in TP_TRAIN_SHAPES]]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("S,d,F,dtype", FNMB_SHAPES)
def test_fused_norm_matmul_bwd_on_card(card, S, d, F, dtype):
    """The backward kernel against its plain version with the forward's
    tolerances (as the largest error over each gradient's largest value:
    dN and the normalized rows round to bf16 once in bf16), counted once a
    call, and two calls bit for bit alike (no atomics)."""
    x, g, w = _fnm_inputs(13, S, d, F, dtype)
    dy = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (S, F)).astype(np.float32)).to("cuda", getattr(torch, dtype))
    n = ops.LAUNCHES["fused_norm_matmul_bwd"]
    got = ops.fused_norm_matmul_bwd(x, g, w, dy)
    assert ops.LAUNCHES["fused_norm_matmul_bwd"] == n + 1
    want = ref.fused_norm_matmul_bwd_ref(x, g, w, dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.is_cuda
        assert _rel(a, b) <= FNM_TOL[dtype]
    for a, b in zip(ops.fused_norm_matmul_bwd(x, g, w, dy), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,d,F,dtype,aligned,want", [
    (2048, 2048, 512, "bfloat16", True, ("wgmma", 128, 2, False)),
    (2048, 2048, 2048, "bfloat16", True, ("wgmma", 256, 1, False)),
    (300, 1100, 1800, "bfloat16", True, ("wgmma", 256, 1, False)),
    (200, 640, 384, "bfloat16", True, ("wgmma", 128, 4, False)),
    (100, 1004, 256, "bfloat16", True, ("wgmma", 128, 2, False)),
    (64, 2304, 256, "bfloat16", True, ("wgmma", 128, 1, True)),
    (9, 64, 131, "bfloat16", True, ("mma", 128, 1, False)),
    (96, 256, 512, "bfloat16", False, ("mma", 128, 1, False)),
    (33, 2304, 131, "bfloat16", True, ("mma", 128, 1, True)),
    (256, 512, 1024, "float32", True, ("fma", 128, 1, False)),
    (7, 2048, 1000, "float32", True, ("fma", 128, 1, True)),
    (9, 7000, 64, "float32", True, ("fma", 128, 1, True))])
def test_fused_norm_matmul_bwd_regimes_on_card(card, S, d, F, dtype, aligned,
                                               want):
    """Each regime of ``ops.fused_norm_matmul_bwd_dw_plan`` (and both row
    passes) against the plain version with the forward's tolerances (bf16
    3e-2, float32 1e-4), and two calls bit for bit alike, a split plan's
    among them (its partials are summed in split order, no atomics).  dy
    off a 16-byte boundary takes the mma regime; wgmma's two tile widths
    run, the wide one at ragged S, d and F; d = 7000 has the row pass's
    warps add to dgamma in turn."""
    x, g, w = _fnm_inputs(16, S, d, F, dtype)
    vals = torch.from_numpy(np.random.default_rng(17).standard_normal(
        S * F).astype(np.float32)).to("cuda", getattr(torch, dtype))
    buf = torch.empty(S * F + 8, dtype=vals.dtype, device="cuda")
    dy = buf[:S * F] if aligned else buf[1:1 + S * F]
    dy.copy_(vals)
    dy = dy.view(S, F)
    assert dy.is_contiguous() and (dy.data_ptr() % 16 == 0) == aligned
    plan = ops.fused_norm_matmul_bwd_dw_plan(S, d, F, x.element_size(), card,
                                             aligned)
    assert (plan["regime"], plan["reread"]) == (want[0], want[3])
    # the tile and splits of an H100's 132 SMs
    assert (plan["tile"][1], plan["splits"]) == want[1:3] or card != 132
    got = ops.fused_norm_matmul_bwd(x, g, w, dy)
    want_g = ref.fused_norm_matmul_bwd_ref(x, g, w, dy)
    for a, b in zip(got, want_g):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= FNM_TOL[dtype]
    for a, b in zip(ops.fused_norm_matmul_bwd(x, g, w, dy), got):
        assert torch.equal(a, b)


def test_fused_norm_matmul_grad_goes_through_both_kernels_on_card(card):
    """With a gradient asked for, the forward kernel runs inside
    ``FusedNormMatmul`` and its backward is the backward kernel; without
    one, no node and no backward launch."""
    x, g, w = _fnm_inputs(15, 64, 256, 96, "bfloat16")
    dy = torch.ones((64, 96), dtype=torch.bfloat16, device="cuda")
    ops.reset_launch_counts()
    with torch.no_grad():
        assert ops.fused_norm_matmul(x, g, w.requires_grad_()).grad_fn is None
    out = ops.fused_norm_matmul(x, g, w)
    assert type(out.grad_fn).__name__ == "FusedNormMatmulBackward"
    (dw,) = torch.autograd.grad(out, (w,), dy)
    assert ops.LAUNCHES["fused_norm_matmul"] == 2
    assert ops.LAUNCHES["fused_norm_matmul_bwd"] == 1
    assert torch.equal(dw, ops.fused_norm_matmul_bwd(x, g, w.detach(),
                                                     dy)[2])


def _train_cfg(arch, dtype):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b",
                                  "llava-next-mistral-7b", "mixtral-8x22b",
                                  "deepseek-v3-671b", "jamba-v0.1-52b",
                                  "whisper-large-v3"])
def test_train_step_on_card_matches_cpu(card, arch):
    """One float32 ``make_train_step`` step of the reduced config on the
    card and on the CPU from the same weights and batch: loss and gnorm
    within 1e-5 relative, first moments within 1e-4 of each leaf's largest
    value (the same sums in another order), parameters within 2 lr (Adam's
    first step moves each by about lr times its gradient's sign)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models.common import sorted_leaves, tree_map
    from repro_torch.models.lm import LM, init_params
    from repro_torch.train import SyntheticLM, init_state, make_train_step
    cfg = _train_cfg(arch, "float32")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    p_cpu = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    batch = SyntheticLM(cfg.vocab_size, 32, 4, seed=2,
                        frontend=("vision" if cfg.vision_tokens else
                                  "audio" if cfg.is_encdec else None),
                        d_model=cfg.d_model,
                        aux_len=cfg.vision_tokens or cfg.encoder_seq
                        ).global_batch_at(0)
    out = {}
    ops.reset_launch_counts()
    for d in ("cuda", "cpu"):
        state = init_state(tree_map(lambda t: t.to(d), p_cpu))
        out[d] = make_train_step(LM(cfg, device=d), tcfg)(state, batch)
    (gs, gm), (cs, cm) = out["cuda"], out["cpu"]
    assert gs.params["embed"].is_cuda
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(float(gm[k]), float(cm[k]), rtol=1e-5)
    for (_, a), (_, b) in zip(sorted_leaves(gs.m), sorted_leaves(cs.m)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    for (_, a), (_, b) in zip(sorted_leaves(gs.params),
                              sorted_leaves(cs.params)):
        assert float((a.cpu() - b).abs().max()) <= 2e-3 + 1e-6
    if cfg.family == "dense":  # 5 entries a layer, forward and remat
        assert ops.LAUNCHES["fused_norm_matmul"] == 10 * cfg.num_layers
        assert ops.LAUNCHES["fused_norm_matmul_bwd"] == 5 * cfg.num_layers


@pytest.mark.parametrize("microbatch", [0, 2])
def test_inplace_train_step_on_card_equals_functional(card, microbatch):
    """The reduced llama3.2-1b in bf16 on the card: three in-place steps
    (``make_train_step(..., inplace=True)``) equal three functional steps
    bit for bit from equal states, the state handed back with every leaf
    in its own storage."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models.common import sorted_leaves, tree_map
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticLM, init_state, make_train_step
    model = LM(_train_cfg("llama3.2-1b", "bfloat16"), device="cuda")
    params = model.init(0)
    tcfg = TrainConfig(total_steps=20, warmup_steps=2, microbatch=microbatch)
    fs = init_state(params)
    held = init_state(tree_map(torch.clone, params))
    ptrs = [t.data_ptr() for _, t in sorted_leaves(held.tree())]
    fstep = make_train_step(model, tcfg)
    istep = make_train_step(model, tcfg, inplace=True)
    src = SyntheticLM(model.cfg.vocab_size, 32, 4, seed=5)
    ist = held
    for i in range(3):
        fs, fm = fstep(fs, src.global_batch_at(i))
        ist, im = istep(ist, src.global_batch_at(i))
        assert ist is held and torch.equal(fm["loss"], im["loss"])
    assert ptrs == [t.data_ptr() for _, t in sorted_leaves(ist.tree())]
    for (_, x), (_, y) in zip(sorted_leaves(fs.tree()),
                              sorted_leaves(ist.tree())):
        assert x.is_cuda and torch.equal(x, y)


def test_checkpoint_restart_on_card_is_bit_exact(card, tmp_path):
    """The reduced llama3.2-1b in bf16 on the card: three steps, a save,
    two more; a restore and a replay of the two give the same state bit
    for bit (no atomics on the path, so the replay is deterministic)."""
    _restart_replays(tmp_path, "llama3.2-1b")


def test_moe_checkpoint_restart_on_card_is_bit_exact(card, tmp_path):
    """The same restart of the reduced deepseek-v3-671b (MLA, the binned
    MoE with its shared expert, the MTP and aux losses): its dispatch and
    combine backwards sum in a fixed order, so the replay is bit for
    bit."""
    _restart_replays(tmp_path, "deepseek-v3-671b")


def _restart_replays(tmp_path, arch):
    import dataclasses
    from repro_torch.configs import TrainConfig
    from repro_torch.models.common import sorted_leaves
    from repro_torch.models.lm import LM
    from repro_torch.train import (SyntheticLM, init_state, make_train_step,
                                   restore, save)
    model = LM(_train_cfg(arch, "bfloat16"), device="cuda")
    params = model.init(0)
    step = make_train_step(model, TrainConfig(total_steps=20,
                                              warmup_steps=2))
    src = SyntheticLM(model.cfg.vocab_size, 32, 4, seed=0)
    state = init_state(params)
    for i in range(3):
        state, _ = step(state, src.global_batch_at(i))
    save(str(tmp_path), int(state.step), state.tree())
    a = state
    for i in (3, 4):
        a, ma = step(a, src.global_batch_at(i))
    t = restore(str(tmp_path), state.tree())
    b = dataclasses.replace(init_state(params), params=t["params"], m=t["m"],
                            v=t["v"], step=t["step"])
    for i in (3, 4):
        b, mb = step(b, src.global_batch_at(i))
    assert torch.equal(ma["loss"], mb["loss"])
    for (_, x), (_, y) in zip(sorted_leaves(a.tree()),
                              sorted_leaves(b.tree())):
        assert x.is_cuda and torch.equal(x, y)


# ------------------------------------------------------ tensor parallelism
TP_SHARD_PAIRS = [(5120, 2560), (5120, 512), (5120, 6912), (6144, 3072),
                  (6144, 512)]


@pytest.mark.parametrize("S,d,F", [(S, d, F) for d, F in TP_SHARD_PAIRS
                                   for S in (4, 8)] + TP_TRAIN_SHAPES)
def test_fused_norm_matmul_at_tp_shard_shapes_on_card(card, S, d, F):
    """Row 5 at each rank's q, k / v and gate / up columns at tp = 2 in
    decode, and at the tp training steps' shapes."""
    x, g, w, got = _check_fnm(S, d, F, "bfloat16")
    assert torch.equal(got, ops.fused_norm_matmul(x, g, w))


def _tp_world(mode: str, tmp_path) -> list:
    """Two ranks of ``tools/tp_rank.py MODE`` on the card -> their JSON."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    tool = Path(__file__).resolve().parents[1] / "tools" / "tp_rank.py"
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(tool), mode,
                               str(tmp_path / "rdv"), str(r), str(outs[r])],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [json.loads(o.read_text()) if o.exists() else {"error": lg}
            for o, lg in zip(outs, logs)]


def test_tp_world_of_two_ranks_on_card(card, tmp_path):
    """gloo serves all_reduce and all_gather of card tensors of each dtype
    between two ranks on one card."""
    for out in _tp_world("probe", tmp_path):
        for op in ("all_reduce", "all_gather"):
            for dt in ("bfloat16", "float32", "int8"):
                assert out["ops"][f"{op}/{dt}"] == "ok", out


@pytest.fixture(scope="module")
def reduced_world(tmp_path_factory):
    """The ``reduced`` world of two ranks on the card, once for the module
    -> rank 0's JSON."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    outs = _tp_world("reduced", tmp_path_factory.mktemp("tp_reduced"))
    for out in outs:
        assert "error" not in out, out.get("traceback", out["error"])
    return outs[0]


def test_tp_reduced_twins_on_card(card, reduced_world):
    """tp = 2 against the whole program on the card: the reduced qwen2.5-14b
    with padded heads and mixtral with a shared expert (float32 prefill and
    decode within 1e-4, the same argmax, routing and bins), and the (2, 1)
    ZeRO-1 step against the plain step within 1e-5, in place equal to the
    functional step bit for bit."""
    twin = reduced_world
    assert twin["qwen2.5-14b"]["same_argmax"]
    assert twin["qwen2.5-14b"]["max_abs_err"] <= 1e-4
    assert twin["mixtral-8x22b"]["routing_equal"]
    assert twin["mixtral-8x22b"]["bins_equal"]
    assert twin["zero_twin_max_abs_err"] <= 1e-5
    assert twin["zero_twin_inplace_equal"]


@pytest.mark.parametrize("key", ["deepseek-v3-671b", "jamba-v0.1-52b",
                                 "rwkv6-1.6b", "whisper-large-v3",
                                 "mixtral-8x22b/gather", "llama3.2-1b/data"])
def test_tp_reduced_family_twins_on_card(card, reduced_world, key):
    """The other mixers at tp = 2 (mla, mamba, rwkv, whisper's
    cross-attention and encoder), ``moe_gather_decode`` and llama3.2-1b
    over (2, 1) against the whole program on the card: float32 prefill and
    decode within 1e-4, the same argmax (and for MoE the same routing and
    bins)."""
    twin = reduced_world[key]
    assert twin["same_argmax"]
    assert twin["max_abs_err"] <= 1e-4
    if "routing_equal" in twin:
        assert twin["routing_equal"] and twin["bins_equal"]


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-v0.1-52b",
                                  "rwkv6-1.6b", "whisper-large-v3"])
def test_tp_reduced_family_train_steps_on_card(card, reduced_world, arch):
    """One float32 (1, 2) train step of the reduced family against the plain
    step on the card: the loss, the gradient (within 1e-5 of its leaf's
    scale) and the update within 1e-5, and as many launches of rows 5 and
    6 as the plain step's."""
    step = reduced_world["train_families"][arch]
    assert step["loss_diff"] <= 1e-5
    assert step["grad_err"] <= 1e-5
    assert step["update_err"] <= 1e-5
    for k in ("fused_norm_matmul", "fused_norm_matmul_bwd"):
        assert step["launches"][k] == step["plain_launches"][k]


@pytest.fixture(scope="module")
def seq_world(tmp_path_factory):
    """The ``seq_reduced`` world of two ranks on the card, once for the
    module -> rank 0's JSON."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    outs = _tp_world("seq_reduced", tmp_path_factory.mktemp("tp_seq"))
    for out in outs:
        assert "error" not in out, out.get("traceback", out["error"])
    return outs[0]


@pytest.mark.parametrize("key", ["llama3.2-1b", "deepseek-v3-671b",
                                 "mixtral-8x22b", "jamba-v0.1-52b",
                                 "rwkv6-1.6b"])
def test_tp_split_cache_twins_on_card(card, seq_world, key):
    """A decode over a split sequence (over ``model`` under
    ``cache_seq_shard``, over ``data`` for a batch-1 cache) against the
    same model and seeded cache unsplit on the card: ten float32 steps
    within 1e-4 and the same argmax."""
    twin = seq_world["twins"][key]
    assert twin["seq_axes"] == (["model"] if twin["mesh"] == [1, 2]
                                else ["data"])
    assert twin["same_argmax"]
    assert twin["max_abs_err"] <= 1e-4
