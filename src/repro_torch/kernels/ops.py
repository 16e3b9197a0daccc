"""Wrappers around the port's CUDA kernels, dispatched by the tensor's device.

A CUDA tensor gets the hand-written kernel (``csrc/*.cu``, built at first
use by ``repro_torch.kernels.build``) or an error: never the plain version.
A CPU tensor gets the plain PyTorch version from ``ref.py``, which is how
the tests run the same path on a machine without a card.

The index wrappers take int32 tensors holding uint32 bit patterns; the
paged-attention wrappers take float32 or bfloat16 queries and pools and
int32 page ids; ``fused_norm_matmul`` takes float32 or bfloat16 matrices.
Every wrapper checks device, dtype, shape, contiguity and the bounds its
kernel relies on, and raises on anything the kernel does not take.  The
kernel masks its own ragged edge, so no padding is needed.  It launches
on the current stream and raises if ``cudaGetLastError()`` is not 0.
:data:`LAUNCHES` counts the launches of each kernel, and nothing else adds
to it.  A paged-attention call counts one, though it may make two CUDA
launches: the split pass over KV heads x runs of pages, and the combine
pass over the runs' partials (see ``csrc/paged_attention.cu``).  A
``fused_norm_matmul`` call counts one too: its plan
(:func:`fused_norm_matmul_plan`) makes one or two CUDA launches (see
``csrc/fused_norm_matmul.cu``).  Its backward,
:func:`fused_norm_matmul_bwd`, counts one for its three or four CUDA
launches (``csrc/fused_norm_matmul_bwd.cu``); :func:`fused_norm_matmul`
goes through the autograd node :class:`FusedNormMatmul` only when a
gradient is asked for, so a call without one makes no node and launches
as before.

The checks that only the CUDA kernels need (the paged kernels' head
widths, shared memory, grid and alignment) run on the CUDA branch alone:
a CPU tensor gets the plain version at any width the reference computes.

The dry run (``launch/dryrun.py``) traces a rank's program on the
``meta`` device, which has shapes and no values: :func:`fused_norm_matmul`
and its backward, the only wrappers on the model's path, take meta
tensors and return empty outputs of the right shapes and dtypes.  On
every device, each of their calls reports its kernel's work (FLOPs and
the bytes it must move) to the active counter of :data:`COUNTERS`
(``launch/hlo_analysis.py::CostMode``), which counts none of the torch
ops the wrapper runs itself; so a kernel's work counts the same on
``meta``, on the CPU and on the card.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"ludo_lookup": 0, "slot_unpack": 0, "paged_attention": 0,
            "cuckoo_paged_attention": 0, "fused_norm_matmul": 0,
            "fused_norm_matmul_bwd": 0}
# the float types the paged-attention and fused-norm kernels are built for
POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
NORM_EPS = 1e-6  # the RMSNorm epsilon of the models and of the kernel
# The paged kernels' split pass: a block takes one KV head, a tile of
# PAGED_QUERY_TILE of its query rows and a run of split_pages logical pages;
# the plan aims at PAGED_BLOCKS_PER_SM blocks an SM, with runs of 16 to 64
# pages (csrc/paged_attention.cu: kQ, kMaxSplitPages, __launch_bounds__).
PAGED_QUERY_TILE = 4
PAGED_MIN_SPLIT_PAGES, PAGED_MAX_SPLIT_PAGES = 16, 64
PAGED_BLOCKS_PER_SM = 6
PAGED_MAX_HEAD_BLOCKS = 65535  # the grid's y limit: n_kv x query tiles
# A split block keeps 2-4 loop steps of K and V rows in shared memory, at
# most 227 KB (csrc/paged_attention.cu: split_smem_bytes, kSmemLimit).
PAGED_MAX_STAGES, PAGED_SMEM_LIMIT = 4, 232448
PAGED_ROWS_PER_ITER = 32
# fused_norm_matmul (csrc/fused_norm_matmul.cu).  Up to FNM_DECODE_MAX_ROWS
# rows of x split d into K-splits of krange rows whose float32 partials a
# combine pass sums (one split: no combine).  In bf16, with w rows of whole
# 16-byte chunks, the mma regime: blocks of FNM_MMA_COLS columns of w x
# K-splits of about FNM_MMA_SPLIT_ROWS rows (krange a multiple of
# FNM_MMA_KRANGE_UNIT, at most FNM_MAX_KRANGE: the block's x * gamma in
# shared memory and registers), at most FNM_MMA_MAX_SPLITS and
# FNM_MMA_MAX_BLOCKS_PER_SM blocks an SM where d allows.
FNM_REGIMES = ("stream", "fma", "wgmma", "mma")
FNM_DECODE_MAX_ROWS = 32
FNM_MAX_KRANGE = 512
FNM_MMA_COLS = 128
FNM_MMA_SPLIT_ROWS, FNM_MMA_KRANGE_UNIT = 128, 64
FNM_MMA_MAX_SPLITS, FNM_MMA_MAX_BLOCKS_PER_SM = 16, 1
# Otherwise the stream regime on the CUDA cores: blocks of FNM_ROW_BYTES of
# a w row x K-splits (krange a multiple of FNM_KRANGE_UNIT, at most
# FNM_MAX_KRANGE) x groups of FNM_ROW_GROUP rows of x, about
# FNM_BLOCKS_PER_SM blocks an SM, at most FNM_MAX_SPLITS splits where d
# allows.  More rows take the FMA tile (float32) or wgmma (bf16), after a
# rows pass that writes x * gamma padded to FNM_PAD columns and the inverse
# RMS of each row.
FNM_ROW_BYTES = 128
FNM_ROW_GROUP = 8
FNM_KRANGE_UNIT = 32
FNM_BLOCKS_PER_SM = 4
FNM_MAX_SPLITS = 16
FNM_PAD = 64
# the output tiles of the FMA tile and of the tensor cores (rows, columns)
FNM_FMA_TILE, FNM_WGMMA_TILE = (64, 64), (128, 128)
# the CUDA kernels a call may launch, as the profiler names them
FNM_KERNELS = ("fused_norm_matmul_mma_kernel",
               "fused_norm_matmul_stream_kernel",
               "fused_norm_matmul_combine_kernel",
               "fused_norm_matmul_rows_kernel",
               "fused_norm_matmul_fma_kernel",
               "fused_norm_matmul_wgmma_kernel")
# fused_norm_matmul_bwd (csrc/fused_norm_matmul_bwd.cu): the row pass takes
# blocks of fused_norm_matmul_bwd_plan rows (a warp a row), about
# FNM_BWD_BLOCKS_PER_SM blocks an SM, each holding its float32 dgamma
# partial (d floats) in shared memory, so d is at most FNM_BWD_MAX_D.  A
# warp keeps a row of x and of dN in registers where d * elt is at most
# FNM_BWD_RESIDENT_BYTES, else reads it again (``reread``).  dw runs in
# one of FNM_BWD_REGIMES (fused_norm_matmul_bwd_dw_plan): tiles of dw
# (rows of d, columns of F), one block a tile: wgmma FNM_BWD_WGMMA_TILE
# where those tiles fill at least half the SMs, else FNM_BWD_DW_TILE (as
# mma and fma); wgmma splits S (steps of FNM_BWD_STEP rows) into at most
# FNM_BWD_MAX_SPLITS ranges where its tiles alone leave SMs idle, and keeps
# A = x * r * gamma in bf16 rows padded to FNM_PAD.
FNM_BWD_BLOCKS_PER_SM = 2
FNM_BWD_MAX_D = PAGED_SMEM_LIMIT // 4
FNM_BWD_RESIDENT_BYTES = 4096
FNM_BWD_REGIMES = ("fma", "mma", "wgmma")
FNM_BWD_DW_TILE, FNM_BWD_WGMMA_TILE = (128, 128), (128, 256)
FNM_BWD_STEP = 64
FNM_BWD_MAX_SPLITS = 8
FNM_BWD_KERNELS = ("fused_norm_matmul_bwd_warp_rows_kernel",
                   "fused_norm_matmul_bwd_reduce_kernel",
                   "fused_norm_matmul_bwd_dw_kernel",
                   "fused_norm_matmul_bwd_wgmma_kernel",
                   "fused_norm_matmul_bwd_dwsum_kernel")
# ludo_lookup (csrc/ludo_lookup.cu, ludo_lookup_plan): one key a thread in
# blocks of LUDO_MIN_THREADS to LUDO_MAX_THREADS threads
LUDO_MIN_THREADS, LUDO_MAX_THREADS = 32, 256
_M32, _M64 = (1 << 32) - 1, (1 << 64) - 1
# the active work counters (launch/hlo_analysis.py's CostMode), innermost
# last: a wrapper call reports its kernel's work to the last
COUNTERS: list = []


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t, dtype: torch.dtype, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, got shape "
                         f"{tuple(t.shape)} (contiguous={t.is_contiguous()})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _stream(device: torch.device) -> int:
    """The current stream of ``device`` as a raw handle; PyTorch's raw
    getter where the build has it skips making a ``torch.cuda.Stream``."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _launch(device: torch.device, fn, *args) -> int:
    """``fn(*args)`` with ``device`` current: the device guard is entered
    only when another device is current."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


def ludo_magic(d: int) -> int:
    """The kernel's multiplier for ``a % d`` (``1 <= d < 2^32``):
    ``floor((2^64 - 1) / d) + 1`` mod 2^64, so that ``a % d`` is the high
    64 bits of ``(m * a mod 2^64) * d`` for every 32-bit ``a`` (0 at
    d = 1, where m wraps to 0)."""
    return (_M64 // d + 1) & _M64


def ludo_lookup_plan(n: int, n_sm: int) -> dict:
    """How ``csrc/ludo_lookup.cu`` takes ``n`` keys on a card of ``n_sm``
    SMs -> ``dict(threads, blocks)``: one key a thread, in blocks of the
    least power of two from ``LUDO_MIN_THREADS`` to ``LUDO_MAX_THREADS``
    threads that holds an SM's share of the batch, so a small batch
    spreads over many SMs, and as many blocks as the batch fills (none for
    an empty one)."""
    return dict(zip(("threads", "blocks"), _ludo_plan(n, n_sm)))


@functools.lru_cache(maxsize=256)
def _ludo_plan(n: int, n_sm: int) -> tuple:
    share = max(1, -(-n // n_sm))
    threads = min(LUDO_MAX_THREADS,
                  max(LUDO_MIN_THREADS, 1 << (share - 1).bit_length()))
    return threads, -(-n // threads)


@functools.lru_cache(maxsize=64)
def _ludo_scalars(ma, mb, nb, seed_a, seed_b, seed_ba, seed_bb) -> tuple:
    """The launch's arguments after ``n``, made once for each CN: the
    magics of ma, mb and nb, the sizes, and the four seeds as uint32."""
    ma, mb, nb = int(ma), int(mb), int(nb)
    return (ludo_magic(ma), ludo_magic(mb), ludo_magic(nb), ma, mb, nb,
            *(int(s) & _M32 for s in (seed_a, seed_b, seed_ba, seed_bb)))


def ludo_lookup(key_lo, key_hi, words_a, words_b, seeds, meta: dict):
    """Batched CN locator: keys -> (bucket, slot), int32 each.

    ``words_a``/``words_b`` are the Othello words (int32 bit patterns),
    ``seeds`` the per-bucket uint8 seeds, and ``meta`` =
    ``dict(ma, mb, nb, seed_a, seed_b, seed_ba, seed_bb)`` (see
    :func:`cn_meta_from` and ``LudoCN.meta``).  On the card, bucket and
    slot are the two rows of one ``(2, n)`` tensor."""
    device = key_lo.device if isinstance(key_lo, torch.Tensor) else None
    _check("key_lo", key_lo, torch.int32, device)
    _check("key_hi", key_hi, torch.int32, device)
    _check("words_a", words_a, torch.int32, device)
    _check("words_b", words_b, torch.int32, device)
    _check("seeds", seeds, torch.uint8, device)
    n, n_hi = key_lo.numel(), key_hi.numel()
    if n_hi != n:
        raise ValueError(f"key_lo/key_hi lengths differ: {n} vs {n_hi}")
    ma, mb, nb = meta["ma"], meta["mb"], meta["nb"]
    if max(ma, mb, nb) > _M32:
        raise ValueError(f"Othello sizes ma={ma}, mb={mb} and nb={nb} must "
                         f"lie below 2^32")
    n_wa, n_wb, n_seeds = words_a.numel(), words_b.numel(), seeds.numel()
    if not 0 < ma <= 32 * n_wa or not 0 < mb <= 32 * n_wb:
        raise ValueError(f"Othello sizes ma={ma}, mb={mb} exceed the words "
                         f"given ({n_wa}, {n_wb})")
    if not 0 < nb <= n_seeds:
        raise ValueError(f"nb={nb} exceeds the {n_seeds} seeds given")
    if n >= 2**31:
        raise ValueError(f"batch of {n} keys exceeds the kernel's int index")
    if device.type == "cpu":
        return ref.ludo_lookup_ref(
            key_lo, key_hi, words_a, words_b, seeds, ma=ma, mb=mb, nb=nb,
            seed_a=meta["seed_a"], seed_b=meta["seed_b"],
            seed_ba=meta["seed_ba"], seed_bb=meta["seed_bb"])
    if device.type != "cuda":
        raise ValueError(f"ludo_lookup runs on cuda or cpu, not {device}")
    out = torch.empty((2, n), dtype=torch.int32, device=device)
    if n:
        ptr = out.data_ptr()
        err = _launch(device, build.launcher("ludo_lookup"),
                      key_lo.data_ptr(), key_hi.data_ptr(),
                      words_a.data_ptr(), words_b.data_ptr(),
                      seeds.data_ptr(), ptr, ptr + 4 * n, n,
                      *_ludo_scalars(ma, mb, nb, meta["seed_a"],
                                     meta["seed_b"], meta["seed_ba"],
                                     meta["seed_bb"]),
                      *_ludo_plan(n, _sm_count(device)), _stream(device))
        _raise_on(err, "ludo_lookup")
        LAUNCHES["ludo_lookup"] += 1
    return out.unbind(0)


def slot_unpack(s_lo, s_hi):
    """Packed 64-bit DMPH slots -> (cache, fp, length, addr), int32 each
    (``addr`` is the uint32 address as an int32 bit pattern).  On the card
    the four are the rows of one ``(4, n)`` tensor."""
    device = s_lo.device if isinstance(s_lo, torch.Tensor) else None
    _check("s_lo", s_lo, torch.int32, device)
    _check("s_hi", s_hi, torch.int32, device)
    n, n_hi = s_lo.numel(), s_hi.numel()
    if n_hi != n:
        raise ValueError(f"s_lo/s_hi lengths differ: {n} vs {n_hi}")
    if n >= 2**31:
        raise ValueError(f"batch of {n} slots exceeds the kernel's int index")
    if device.type == "cpu":
        return ref.slot_unpack_ref(s_lo, s_hi)
    if device.type != "cuda":
        raise ValueError(f"slot_unpack runs on cuda or cpu, not {device}")
    out = torch.empty((4, n), dtype=torch.int32, device=device)
    if n:
        ptr = out.data_ptr()
        err = _launch(device, build.launcher("slot_unpack"), s_lo.data_ptr(),
                      s_hi.data_ptr(), ptr, ptr + 4 * n, ptr + 8 * n,
                      ptr + 12 * n, n, _stream(device))
        _raise_on(err, "slot_unpack")
        LAUNCHES["slot_unpack"] += 1
    return out.unbind(0)


def _check_int32(name: str, t, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor of shape {shape}, "
                         f"got {tuple(t.shape)} (contiguous={t.is_contiguous()})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def paged_split_plan(n_pages: int, n_kv: int, g: int, n_sm: int) -> tuple:
    """The paged kernels' split of ``n_pages`` logical pages over a card of
    ``n_sm`` SMs -> ``(split_pages, n_splits)``: runs of ``split_pages``
    pages (the last one shorter), enough of them that the split pass's
    blocks (one a KV head, query tile and run) put about
    ``PAGED_BLOCKS_PER_SM`` on each SM, each run 16 to 64 pages long.  A
    cuckoo page's two candidates are one logical page, so they stay in one
    run."""
    heads = n_kv * -(-g // PAGED_QUERY_TILE)
    per_block = -(-n_pages * heads // (PAGED_BLOCKS_PER_SM * n_sm))
    split_pages = min(PAGED_MAX_SPLIT_PAGES,
                      max(PAGED_MIN_SPLIT_PAGES, per_block))
    return split_pages, -(-n_pages // split_pages)


def paged_smem_bytes(stages: int, ps: int, d: int, elt: int) -> int:
    """Shared memory of a split block keeping ``stages`` loop steps of
    ``max(1, 32 // ps)`` pages in flight: the ring of K and V rows (at least
    the 4 x 4 x d floats of the warps' final merge), 32 floats a warp for
    its p and alpha, the run's page ids and selects, and a flag a step in
    the ring (``split_smem_bytes`` in ``csrc/paged_attention.cu``)."""
    spi = max(1, PAGED_ROWS_PER_ITER // ps)
    ring = max(stages * 2 * spi * ps * d * elt, 4 * 4 * PAGED_QUERY_TILE * d)
    return ring + 4 * 4 * 32 + 4 * (3 * PAGED_MAX_SPLIT_PAGES + stages * spi)


@functools.cache
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device: torch.device) -> int:
    return _sm_count_of(torch.cuda.current_device() if device.index is None
                        else device.index)


def _check_paged(q, k_pool, v_pool, n_pages: int, seq_len) -> dict:
    """Check the operands shared by both paged kernels; returns the launch
    sizes."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"q must be a torch.Tensor, got {type(q).__name__}")
    device = q.device
    if q.dtype not in POOL_DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (n_kv, g, d) tensor, got "
                         f"shape {tuple(q.shape)}")
    n_kv, g, d = (int(x) for x in q.shape)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} like q, got {t.dtype}")
        if (t.dim() != 4 or tuple(t.shape[2:]) != (n_kv, d)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (P, ps, {n_kv}, "
                             f"{d}) tensor, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool/v_pool shapes differ: "
                         f"{tuple(k_pool.shape)} vs {tuple(v_pool.shape)}")
    n_pool, ps = int(k_pool.shape[0]), int(k_pool.shape[1])
    if n_pages < 1 or int(seq_len) < 1:
        raise ValueError(f"need at least one page and one valid token, got "
                         f"{n_pages} pages and seq_len={seq_len}")
    if n_pool >= 2**31 or 2 * n_pages >= 2**31 or int(seq_len) >= 2**31:
        raise ValueError("a size exceeds the kernel's int index")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged attention runs on cuda or cpu, not {device}")
    return dict(device=device, n_kv=n_kv, g=g, d=d, n_pool=n_pool, ps=ps,
                dtype=POOL_DTYPES[q.dtype], seq_len=int(seq_len))


def _check_paged_cuda(sz: dict, k_pool, v_pool) -> None:
    """The limits of the CUDA paged kernels, on top of :func:`_check_paged`
    (whose sizes ``sz`` are): a head width they are built for, two loop
    steps of pages in a block's shared memory, the grid's head blocks and
    pools on 16-byte boundaries.  The plain version takes any of these."""
    n_kv, g, d, ps = sz["n_kv"], sz["g"], sz["d"], sz["ps"]
    if d not in HEAD_DIMS:
        raise ValueError(f"head width d={d} is not one of {HEAD_DIMS}")
    if paged_smem_bytes(2, ps, d, k_pool.element_size()) > PAGED_SMEM_LIMIT:
        raise ValueError(f"pages of ps={ps} tokens of d={d} need more than "
                         f"the {PAGED_SMEM_LIMIT} B of shared memory a block "
                         f"may use")
    if n_kv * -(-g // PAGED_QUERY_TILE) > PAGED_MAX_HEAD_BLOCKS:
        raise ValueError(f"n_kv={n_kv} KV heads of g={g} queries exceed the "
                         f"grid's {PAGED_MAX_HEAD_BLOCKS} head blocks")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:  # the kernel copies 16-byte chunks
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _paged_launch(kernel: str, sz: dict, q, k_pool, v_pool, ids: tuple,
                  n_pages: int):
    _check_paged_cuda(sz, k_pool, v_pool)
    device, n_kv, g, d = sz["device"], sz["n_kv"], sz["g"], sz["d"]
    o = torch.empty((n_kv, g, d), dtype=torch.float32, device=device)
    m = torch.empty((n_kv, g), dtype=torch.float32, device=device)
    l = torch.empty((n_kv, g), dtype=torch.float32, device=device)
    split_pages, n_splits = paged_split_plan(n_pages, n_kv, g,
                                             _sm_count(device))
    # the split pass's partials (acc, then m, then l), for the combine pass
    ws = torch.empty(n_kv * n_splits * g * (d + 2), dtype=torch.float32,
                     device=device) if n_splits > 1 else None
    err = _launch(device, build.launcher(kernel), q.data_ptr(),
                  k_pool.data_ptr(), v_pool.data_ptr(),
                  *(t.data_ptr() for t in ids), o.data_ptr(), m.data_ptr(),
                  l.data_ptr(), None if ws is None else ws.data_ptr(),
                  n_pages, sz["n_pool"], sz["ps"], n_kv, g, d, sz["dtype"],
                  sz["seq_len"], split_pages, _stream(device))
    _raise_on(err, kernel)
    LAUNCHES[kernel] += 1
    return o, m, l


def paged_attention(q, k_pool, v_pool, page_map, seq_len):
    """Ludo-paged flash decode for one sequence -> float32 (o, m, l).

    ``q`` (n_kv, g, d) and the pools (P, ps, n_kv, d) are float32 or
    bfloat16 alike; ``page_map`` (L,) int32 holds the physical page of each
    logical page; ``seq_len`` is the number of valid tokens."""
    n_pages = len(page_map)
    sz = _check_paged(q, k_pool, v_pool, n_pages, seq_len)
    _check_int32("page_map", page_map, (n_pages,), sz["device"])
    if sz["device"].type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, page_map, seq_len)
    return _paged_launch("paged_attention", sz, q, k_pool, v_pool,
                         (page_map,), n_pages)


def cuckoo_paged_attention(q, k_pool, v_pool, page_map2, select, seq_len):
    """The two-fetch cuckoo baseline -> float32 (o, m, l).

    ``page_map2`` (L, 2) int32 holds both candidate pages of each logical
    page and ``select`` (L,) int32 which of them is the true one; the kernel
    loads both and masks the other."""
    n_pages = len(page_map2)
    sz = _check_paged(q, k_pool, v_pool, n_pages, seq_len)
    _check_int32("page_map2", page_map2, (n_pages, 2), sz["device"])
    _check_int32("select", select, (n_pages,), sz["device"])
    if sz["device"].type == "cpu":
        pm = page_map2[torch.arange(n_pages), select.long()]
        return ref.paged_attention_ref(q, k_pool, v_pool, pm, seq_len)
    return _paged_launch("cuckoo_paged_attention", sz, q, k_pool, v_pool,
                         (page_map2, select), n_pages)


def _split_d(d: int, want: int, unit: int, most: int) -> tuple:
    """``(krange, splits)``: about ``want`` K-splits of d, each a multiple
    of ``unit`` rows and at most ``most``."""
    per = -(-d // max(1, want))
    krange = min(most, -(-per // unit) * unit)
    return krange, -(-d // krange)


def fused_norm_matmul_plan(S: int, d: int, F: int, elt: int, n_sm: int,
                           w_aligned: bool = True) -> dict:
    """How ``csrc/fused_norm_matmul.cu`` computes an (S, d) x (d, F) call
    of ``elt``-byte values on a card of ``n_sm`` SMs -> ``dict(regime,
    tile, splits, krange)``.

    Up to 32 rows: ``mma`` (bf16 whose w rows are whole 16-byte chunks:
    ``F * elt % 16 == 0`` and ``w`` on a 16-byte boundary) or ``stream``
    (the rest), with ``tile`` columns a block and ``splits`` K-splits of
    ``krange`` rows of d; one split finishes the output in one launch.
    More rows: ``wgmma`` (bf16) or ``fma`` (float32) with ``tile`` =
    (rows, columns) of an output tile over the whole of d, or ``stream``
    where w rows are not whole chunks."""
    whole = F * elt % 16 == 0 and w_aligned
    if S > FNM_DECODE_MAX_ROWS and whole:
        if elt == 2:
            return dict(regime="wgmma", tile=FNM_WGMMA_TILE, splits=1,
                        krange=d)
        return dict(regime="fma", tile=FNM_FMA_TILE, splits=1, krange=d)
    if S <= FNM_DECODE_MAX_ROWS and whole and elt == 2:
        tiles = -(-F // FNM_MMA_COLS)
        want = min(-(-d // FNM_MMA_SPLIT_ROWS), FNM_MMA_MAX_SPLITS,
                   max(1, FNM_MMA_MAX_BLOCKS_PER_SM * n_sm // tiles))
        krange, splits = _split_d(d, want, FNM_MMA_KRANGE_UNIT,
                                  FNM_MAX_KRANGE)
        return dict(regime="mma", tile=FNM_MMA_COLS, splits=splits,
                    krange=krange)
    tile = FNM_ROW_BYTES // elt
    blocks = -(-F // tile) * -(-S // FNM_ROW_GROUP)
    want = min(FNM_MAX_SPLITS, -(-FNM_BLOCKS_PER_SM * n_sm // blocks))
    krange, splits = _split_d(d, want, FNM_KRANGE_UNIT, FNM_MAX_KRANGE)
    return dict(regime="stream", tile=tile, splits=splits, krange=krange)


def fused_norm_matmul_workspace(plan: dict, S: int, d: int, F: int,
                                elt: int) -> int:
    """Float32 workspace a call of ``plan`` needs, in floats: the stream
    and mma regimes' partials ``(splits, S, F)`` and x^2 sums
    ``(splits, S)`` when they have more than one split; the prefill
    regimes' x * gamma (S rows of d padded to ``FNM_PAD``, in the input
    type) and inverse RMS (S)."""
    if plan["regime"] in ("stream", "mma"):
        n = plan["splits"]
        return 0 if n == 1 else n * S * F + n * S
    dp = -(-d // FNM_PAD) * FNM_PAD
    return S * dp * elt // 4 + S


def _check_fnm(x, gamma, w) -> None:
    """The checks of :func:`fused_norm_matmul` and its backward."""
    for name, t, dim in (("x", x, 2), ("gamma", gamma, 1), ("w", w, 2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D tensor, got "
                             f"shape {tuple(t.shape)} "
                             f"(contiguous={t.is_contiguous()})")
    if x.dtype not in POOL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("gamma", gamma), ("w", w)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} like x, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
    (S, d), F = x.shape, w.shape[1]
    if d < 1 or gamma.shape[0] != d or w.shape[0] != d:
        raise ValueError(f"d differs: x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, w {tuple(w.shape)}")
    if max(S * d, d * F, S * F) >= 2**31 or S > 65535 * FNM_ROW_GROUP:
        raise ValueError("a size exceeds the kernel's int index or grid")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"fused_norm_matmul runs on cuda, cpu or meta, not "
                         f"{x.device}")


def fused_norm_matmul(x, gamma, w):
    """``RMSNorm(x; eps=1e-6) * gamma @ w`` -> (S, F) in the dtype of ``x``.

    ``x`` (S, d), ``gamma`` (d,) and ``w`` (d, F) are contiguous tensors of
    one dtype (float32 or bfloat16) on one device; the norm and the product
    accumulate in float32.  With grad mode on and an input that requires
    grad, the call goes through :class:`FusedNormMatmul`, whose backward is
    :func:`fused_norm_matmul_bwd`; otherwise no autograd node is made."""
    _check_fnm(x, gamma, w)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or w.requires_grad):
        return FusedNormMatmul.apply(x, gamma, w)
    return _fused_norm_matmul(x, gamma, w)


def _fused_norm_matmul(x, gamma, w):
    """:func:`fused_norm_matmul` on checked inputs, its work reported to
    the active counter: 2·S·d·F FLOPs, x, gamma and w read once and the
    output written once."""
    if COUNTERS:
        (S, d), F = x.shape, w.shape[1]
        return COUNTERS[-1].kernel_call(
            "fused_norm_matmul", 2.0 * S * d * F,
            float((S * d + d + d * F + S * F) * x.element_size()),
            _fused_norm_matmul_run, x, gamma, w)
    return _fused_norm_matmul_run(x, gamma, w)


def _fused_norm_matmul_run(x, gamma, w):
    """The plain version for a CPU tensor, the kernel for a CUDA one, an
    empty output for a meta one."""
    (S, d), F = x.shape, w.shape[1]
    device = x.device
    if device.type == "cpu":
        return ref.fused_norm_matmul_ref(x, gamma, w, eps=NORM_EPS)
    if device.type == "meta":
        return torch.empty((S, F), dtype=x.dtype, device=device)
    out = torch.empty((S, F), dtype=x.dtype, device=device)
    if S and F:
        elt = x.element_size()
        plan = fused_norm_matmul_plan(S, d, F, elt, _sm_count(device),
                                      w.data_ptr() % 16 == 0)
        n_ws = fused_norm_matmul_workspace(plan, S, d, F, elt)
        ws = torch.empty(n_ws, dtype=torch.float32, device=device) \
            if n_ws else None
        err = _launch(device, build.launcher("fused_norm_matmul"),
                      x.data_ptr(), gamma.data_ptr(), w.data_ptr(),
                      out.data_ptr(), None if ws is None else ws.data_ptr(),
                      S, d, F, POOL_DTYPES[x.dtype], NORM_EPS,
                      FNM_REGIMES.index(plan["regime"]), plan["splits"],
                      plan["krange"], _stream(device))
        _raise_on(err, "fused_norm_matmul")
        LAUNCHES["fused_norm_matmul"] += 1
    return out


def fused_norm_matmul_bwd_plan(S: int, n_sm: int) -> int:
    """Rows of x a block of the backward's row pass takes: about
    ``FNM_BWD_BLOCKS_PER_SM`` blocks an SM over the S rows."""
    return max(1, -(-S // (FNM_BWD_BLOCKS_PER_SM * n_sm)))


def fused_norm_matmul_bwd_workspace(S: int, d: int, rows: int) -> int:
    """Float32 workspace of a backward call's row pass, in floats: the
    inverse RMS of each row (S, rounded up to a multiple of 4), then a
    dgamma partial of d floats for each block of ``rows`` rows."""
    return -(-S // 4) * 4 + -(-S // rows) * d


def fused_norm_matmul_bwd_dw_plan(S: int, d: int, F: int, elt: int,
                                  n_sm: int, aligned: bool = True) -> dict:
    """How ``csrc/fused_norm_matmul_bwd.cu`` computes dw (and whether its
    row pass keeps rows in registers) for an (S, d) x (d, F) call of
    ``elt``-byte values on a card of ``n_sm`` SMs -> ``dict(regime, tile,
    splits, reread)``.

    ``wgmma`` for bf16 whose dy rows are whole 16-byte chunks (``F % 8 ==
    0`` and ``aligned``: dy on a 16-byte boundary), ``mma`` for the rest
    of bf16, ``fma`` for float32; ``tile`` is (rows of d, columns of F) of
    a block: for ``wgmma`` ``FNM_BWD_WGMMA_TILE`` where its tiles fill half
    the SMs or more (a wider tile reads less from L2 a product), else
    ``FNM_BWD_DW_TILE`` (twice the blocks, so fewer S-splits, whose
    partials cost bytes).  ``wgmma`` splits S into ``splits`` ranges of
    whole steps of ``FNM_BWD_STEP`` rows when its tiles leave SMs idle:
    the most splits (at most ``FNM_BWD_MAX_SPLITS``, each with a step)
    whose tiles x splits blocks still run in one wave of ``n_sm`` (a
    second wave of shorter blocks costs what the split saved, and the
    partials cost bytes); the others take all of S in one block.
    ``reread``: a row of x is wider than ``FNM_BWD_RESIDENT_BYTES``, so
    the row pass reads it again for its second pass."""
    reread = d * elt > FNM_BWD_RESIDENT_BYTES
    if elt == 4:
        regime = "fma"
    elif F % 8 == 0 and aligned:
        regime = "wgmma"
    else:
        regime = "mma"
    if regime != "wgmma":
        return dict(regime=regime, tile=FNM_BWD_DW_TILE, splits=1,
                    reread=reread)
    tile = FNM_BWD_WGMMA_TILE
    tiles = -(-d // tile[0]) * -(-F // tile[1])
    if 2 * tiles <= n_sm:
        tile = FNM_BWD_DW_TILE
        tiles = -(-d // tile[0]) * -(-F // tile[1])
    return dict(regime=regime, tile=tile,
                splits=_fnm_bwd_splits(S, tiles, n_sm),
                reread=reread)


def _fnm_bwd_splits(S: int, tiles: int, n_sm: int) -> int:
    """S-splits of a wgmma dw of ``tiles`` tiles: ``n_sm // tiles`` (at
    least 1, at most ``FNM_BWD_MAX_SPLITS`` and the steps of
    ``FNM_BWD_STEP`` rows in S), then as many as ranges of ``ceil(steps /
    that)`` whole steps need, so that none is empty."""
    steps = -(-S // FNM_BWD_STEP)
    want = max(1, min(steps, FNM_BWD_MAX_SPLITS, n_sm // tiles))
    return -(-steps // -(-steps // want))


def fused_norm_matmul_bwd_dw_workspace(plan: dict, S: int, d: int,
                                       F: int) -> int:
    """Float32 workspace of dw, in floats: for ``wgmma``, A (S rows of d
    padded to ``FNM_PAD``, bf16: a multiple of 32 floats, so the partials
    start on a 128-byte boundary), then the float32 partials (splits, d,
    F) when it has more than one split; none for the other regimes."""
    if plan["regime"] != "wgmma":
        return 0
    dp = -(-d // FNM_PAD) * FNM_PAD
    return S * dp // 2 + (plan["splits"] * d * F if plan["splits"] > 1
                          else 0)


def fused_norm_matmul_bwd(x, gamma, w, dy):
    """The gradients of :func:`fused_norm_matmul` given ``dy`` (S, F) ->
    ``(dx, dgamma, dw)`` in the dtypes of ``x``, ``gamma`` and ``w``.

    The inputs are checked as the forward's, and ``dy`` is a contiguous
    (S, F) tensor of their dtype on their device.  A CPU tensor gets the
    plain version; a CUDA one ``dN = dy @ w^T`` by ``torch.matmul`` (in the
    input type), then the kernels of ``csrc/fused_norm_matmul_bwd.cu`` in
    the regime of :func:`fused_norm_matmul_bwd_dw_plan`, which recompute
    the normalized rows, write dx, dgamma and dw, and count one launch.
    A meta one gets ``dN``'s product and empty gradients.  The active
    counter counts ``dN`` as the aten ``mm`` it is on the card (on the
    CPU, where the plain version computes it, as that op on meta
    stand-ins) and the rest as the kernel's work: dw's 2·S·d·F FLOPs,
    x, gamma, dy and dN read once, dx, dgamma and dw written once."""
    _check_fnm(x, gamma, w)
    (S, d), F = x.shape, w.shape[1]
    if not isinstance(dy, torch.Tensor):
        raise TypeError(f"dy must be a torch.Tensor, got {type(dy).__name__}")
    if dy.dtype != x.dtype:
        raise TypeError(f"dy must be {x.dtype} like x, got {dy.dtype}")
    if dy.device != x.device:
        raise ValueError(f"dy is on {dy.device}, expected {x.device}")
    if tuple(dy.shape) != (S, F) or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous ({S}, {F}) tensor, got "
                         f"shape {tuple(dy.shape)} "
                         f"(contiguous={dy.is_contiguous()})")
    device = x.device
    if device.type == "cuda" and d > FNM_BWD_MAX_D:
        raise ValueError(f"d={d} exceeds the {FNM_BWD_MAX_D} columns of a "
                         f"dgamma partial in a block's shared memory")
    if device.type == "cuda" and (S == 0 or F == 0):
        # no term: every gradient is zero
        return (torch.zeros_like(x), torch.zeros_like(gamma),
                torch.zeros_like(w))
    if device.type == "cpu":
        dn = None
        if COUNTERS:
            COUNTERS[-1].count_on_meta(lambda a, b: torch.matmul(a, b.t()),
                                       dy, w)
    else:
        dn = torch.matmul(dy, w.t())
    if not COUNTERS:
        return _fused_norm_matmul_bwd_run(x, gamma, w, dy, dn)
    return COUNTERS[-1].kernel_call(
        "fused_norm_matmul_bwd", 2.0 * S * d * F,
        float((3 * S * d + 2 * d + S * F + d * F) * x.element_size()),
        _fused_norm_matmul_bwd_run, x, gamma, w, dy, dn)


def _fused_norm_matmul_bwd_run(x, gamma, w, dy, dn):
    """:func:`fused_norm_matmul_bwd` after ``dN`` (None on the CPU)."""
    (S, d), F = x.shape, w.shape[1]
    device = x.device
    if device.type == "cpu":
        return ref.fused_norm_matmul_bwd_ref(x, gamma, w, dy, eps=NORM_EPS)
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dw = torch.empty_like(w)
    if device.type == "meta":
        return dx, dgamma, dw
    n_sm = _sm_count(device)
    rows = fused_norm_matmul_bwd_plan(S, n_sm)
    plan = fused_norm_matmul_bwd_dw_plan(S, d, F, x.element_size(), n_sm,
                                         dy.data_ptr() % 16 == 0)
    ws = torch.empty(fused_norm_matmul_bwd_workspace(S, d, rows),
                     dtype=torch.float32, device=device)
    n_dw = fused_norm_matmul_bwd_dw_workspace(plan, S, d, F)
    ws_dw = torch.empty(n_dw, dtype=torch.float32, device=device) \
        if n_dw else None
    err = _launch(device, build.launcher("fused_norm_matmul_bwd"),
                  x.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                  dn.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
                  dw.data_ptr(), ws.data_ptr(),
                  None if ws_dw is None else ws_dw.data_ptr(), S, d, F,
                  POOL_DTYPES[x.dtype], NORM_EPS, rows,
                  FNM_BWD_REGIMES.index(plan["regime"]), plan["tile"][1],
                  plan["splits"], int(plan["reread"]), _stream(device))
    _raise_on(err, "fused_norm_matmul_bwd")
    LAUNCHES["fused_norm_matmul_bwd"] += 1
    return dx, dgamma, dw


class FusedNormMatmul(torch.autograd.Function):
    """:func:`fused_norm_matmul` as an autograd node: it saves only ``x``,
    ``gamma`` and ``w`` (the normalized rows are recomputed), and its
    backward is :func:`fused_norm_matmul_bwd`."""

    @staticmethod
    def forward(ctx, x, gamma, w):
        ctx.save_for_backward(x, gamma, w)
        return _fused_norm_matmul(x, gamma, w)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, w = ctx.saved_tensors
        grads = fused_norm_matmul_bwd(x, gamma, w, dy.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def flash_combine(o_parts, m_parts, l_parts):
    """Combine flash partials of disjoint KV ranges (no kernel, as in the
    reference)."""
    return ref.combine_flash_partials(o_parts, m_parts, l_parts)


def cn_meta_from(shard_or_cn) -> dict:
    """The kernel meta dict of an ``OutbackShard`` or a ``LudoCN``: a copy
    of ``LudoCN.meta``."""
    return dict(getattr(shard_or_cn, "cn", shard_or_cn).meta)
