"""Host-side pieces of the ``ludo_lookup`` kernel, on the CPU.

This file imports only torch, numpy, pytest and ``repro_torch`` (the
reference's side of the last test runs from a text in a subprocess).  It
pins:

* the kernel's modulo (``csrc/ludo_lookup.cu::mod_magic``), modelled in
  Python integers step by step as the kernel takes it (the 64-bit product
  ``m * a``, then its 32-bit halves times ``d``), equal to ``a % d`` for
  d in {1, 2, 3, 7, 2^k, 2^k - 1, 2^k + 1, 2^32 - 1} and the real ``ma``,
  ``mb`` and ``nb`` of shards of several sizes, against the dividends
  {0, 1, d - 1, d, d + 1, 2^32 - 1} and seeded random ones;
* ``ops.ludo_lookup_plan`` over the edges of n (0, 1, one block, each
  block width's last batch and the next, a ragged batch past them, 2^20,
  2^31 - 1) on cards of several SM counts, and a plain model of the
  kernel's index (one key a thread of the grid) that touches every key
  exactly once on the plan's grid and on other covering grids;
* ``ops.ludo_lookup`` refusing CN sizes of 2^32 and more;
* ``LudoCN.meta``, made once for each CN, equal to a fresh
  ``ops.cn_meta_from`` after inserts, updates and deletes on a CPU shard;
* ``LudoCN.bits_per_key`` equal to the reference's for the same keys.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ludo, outback
from repro_torch.core.hashing import lanes, split_u64, splitmix64
from repro_torch.core.othello import Othello
from repro_torch.core.store import make_uniform_keys
from repro_torch.kernels import ops

M32, M64 = (1 << 32) - 1, (1 << 64) - 1


def mod_magic(a: int, m: int, d: int) -> int:
    """The kernel's ``mod_magic``: low = m * a mod 2^64, then the high 64
    bits of low * d from low's 32-bit halves."""
    low = (m * a) & M64
    t = (low >> 32) * d + (((low & M32) * d) >> 32)
    return (t >> 32) & M32


def _shard_geometry(n: int) -> tuple:
    """(ma, mb, nb) of an n-key shard at load factor 0.95, as
    ``othello.build`` and ``ludo.build`` size them."""
    return (max(4, math.ceil(1.33 * n)), max(4, n + 1),
            max(1, math.ceil(n / (4.0 * 0.95))))


SHARD_SIZES = (50, 3000, 40_000, 1 << 20, 1 << 24, 3 << 24)
_REAL = sorted({d for n in SHARD_SIZES for d in _shard_geometry(n)})
DIVISORS = sorted({1, 2, 3, 7, M32}
                  | {1 << k for k in range(32)}
                  | {(1 << k) - 1 for k in range(2, 33)}
                  | {(1 << k) + 1 for k in range(1, 32)}
                  | set(_REAL))


@pytest.mark.parametrize("d", DIVISORS)
def test_magic_modulo_equals_percent(d):
    m = ops.ludo_magic(d)
    assert 0 <= m <= M64 and (m == 0) == (d == 1)
    rng = np.random.default_rng(d & 0xFFFF)
    dividends = {0, 1, d - 1, d, d + 1, M32} | set(
        int(x) for x in rng.integers(0, 1 << 32, 64, dtype=np.uint64))
    for a in sorted(x for x in dividends if 0 <= x <= M32):
        assert mod_magic(a, m, d) == a % d, (a, d)


def test_real_shards_have_the_divisors_tested():
    """Shards built here have the CN sizes that the divisors include."""
    for n in SHARD_SIZES[:2]:
        keys = make_uniform_keys(n)
        sh = outback.OutbackShard(keys, splitmix64(keys), load_factor=0.95,
                                  device="cpu")
        meta = ops.cn_meta_from(sh)
        assert (meta["ma"], meta["mb"], meta["nb"]) == _shard_geometry(n)


# ------------------------------------------------------------------ the plan
N_SMS = (1, 2, 66, 132, 144)
WIDTHS = (32, 64, 128, 256)


def _edges(n_sm: int) -> list:
    """0, 1, a warp and one either side, the serve window and one either
    side, each block width's last batch and the next (t * n_sm, + 1), a
    ragged batch past the widest, 2^20 and the largest batch taken."""
    return sorted({0, 1, 2, 31, 32, 33, 1023, 1024, 1025, 256 * n_sm + 5,
                   1 << 20, 2**31 - 1}
                  | {t * n_sm + d for t in WIDTHS for d in (0, 1)})


def _visits(n: int, threads: int, blocks: int) -> np.ndarray:
    """How often the kernel touches each of n keys: thread t of the grid
    (``blockIdx.x * blockDim.x + threadIdx.x``) takes key t if t < n."""
    t = (np.arange(blocks)[:, None] * threads
         + np.arange(threads)[None, :]).ravel()
    return np.bincount(t[t < n], minlength=n)


@pytest.mark.parametrize("n_sm", N_SMS)
def test_plan_covers_every_edge(n_sm):
    for n in _edges(n_sm):
        plan = ops.ludo_lookup_plan(n, n_sm)
        threads, blocks = plan["threads"], plan["blocks"]
        assert set(plan) == {"threads", "blocks"}
        assert threads in WIDTHS and 1 <= blocks < 2**31 or n == blocks == 0
        # one pass of the grid: every key a thread, no block left empty
        assert blocks * threads >= n and (n == 0 or (blocks - 1) * threads < n)
        # the least width that holds an SM's share, within 32 to 256
        share = -(-n // n_sm)
        assert threads >= min(256, share)
        assert threads == 32 or threads // 2 < share
        if n <= 1 << 20:
            assert np.all(_visits(n, threads, blocks) == 1)


def test_plan_small_batches_spread_over_sms():
    """At the serve window a 132-SM card gets 32 one-warp blocks; one key
    gets one warp; past 32 keys an SM, wider blocks; from 256 keys an SM
    on, blocks of 256."""
    plan = ops.ludo_lookup_plan
    assert plan(1024, 132) == dict(threads=32, blocks=32)
    assert plan(1, 132) == dict(threads=32, blocks=1)
    assert plan(32 * 132, 132) == dict(threads=32, blocks=132)
    assert plan(32 * 132 + 1, 132) == dict(threads=64, blocks=67)
    assert plan(8192, 132) == dict(threads=64, blocks=128)
    assert plan(256 * 132, 132) == dict(threads=256, blocks=132)
    assert plan(1 << 20, 132) == dict(threads=256, blocks=4096)


@pytest.mark.parametrize("n", [1, 5, 33, 1029, 4099])
def test_kernel_takes_each_key_once_on_a_covering_grid(n):
    """The launch takes any grid that covers the batch (and refuses one
    that does not): one thread a key, extra threads idle."""
    for threads in WIDTHS + (1024,):
        for blocks in (-(-n // threads), -(-n // threads) + 3):
            assert np.all(_visits(n, threads, blocks) == 1)
        assert n <= 32 or not np.all(
            _visits(n, 32, (n - 1) // 32) == 1)


@pytest.mark.parametrize("size", ["ma", "nb"])
def test_sizes_past_the_kernels_uint32_are_refused(size):
    """The kernel takes ma, mb and nb as uint32: a CN sized 2^32 is refused
    before anything runs, on the CPU as on the card."""
    lo = torch.zeros(4, dtype=torch.int32)
    words, seeds = torch.zeros(4, dtype=torch.int32), torch.zeros(
        4, dtype=torch.uint8)
    meta = dict(ma=1 << 32 if size == "ma" else 1, mb=1,
                nb=1 << 32 if size == "nb" else 1, seed_a=1, seed_b=2,
                seed_ba=3, seed_bb=4)
    with pytest.raises(ValueError, match="below 2\\^32"):
        ops.ludo_lookup(lo, lo, words, words, seeds, meta)


# ------------------------------------------------------------- cached meta
def test_cached_meta_equals_a_fresh_one_after_writes():
    keys = make_uniform_keys(3000)
    sh = outback.OutbackShard(keys, splitmix64(keys), load_factor=0.95,
                              device="cpu")
    cn = sh.cn
    first = cn.meta
    assert first == ops.cn_meta_from(sh) and cn.meta is first
    rng = np.random.default_rng(3)
    fresh = splitmix64(np.arange(10**6, 10**6 + 200, dtype=np.uint64))
    sh.insert_batch(fresh, fresh)
    sh.update_batch(keys[:300], rng.integers(0, 2**63, 300, dtype=np.uint64))
    sh.delete_batch(keys[300:600])
    assert sh.cn is cn and cn.meta is first
    assert cn.meta == ops.cn_meta_from(sh)
    assert dict(cn.meta) == ops.cn_meta_from(cn)
    assert bool(sh.get_batch(keys[600:900], resolve_makeup=True)[2].all())


def test_cached_meta_follows_a_new_othello():
    lo, hi = (lanes(x, "cpu") for x in split_u64(make_uniform_keys(500)))
    cn = ludo.build(lo, hi).cn
    meta = cn.meta
    with pytest.raises(TypeError):
        meta["ma"] = 1  # read-only: every locate shares it
    oth = cn.othello
    cn.othello = Othello(oth.words_a, oth.words_b, oth.ma - 1, oth.mb,
                         oth.seed_a + 1, oth.seed_b)
    assert cn.meta is not meta and cn.meta == ops.cn_meta_from(cn)
    assert cn.meta["ma"] == meta["ma"] - 1
    assert cn.locate(lo, hi)[0].shape == lo.shape


# ------------------------------------------------------------ bits a key
BITS_CASES = [(50, None), (3000, None), (3000, 1000), (20_000, None)]
# the reference's side: each case's CN built by repro.core.ludo from the
# same keys -> its bucket count, Othello bits and bits a key, as JSON
REF_BITS = textwrap.dedent("""
    import json, sys
    import numpy as np
    from repro.core import ludo
    from repro.core.store import make_uniform_keys
    out = []
    for n, buckets in json.loads(sys.argv[1]):
        keys = make_uniform_keys(n)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        cn = ludo.build(lo, hi, num_buckets=buckets).cn
        out.append([cn.num_buckets, cn.othello.bits, cn.bits_per_key])
    print(json.dumps(out))
""")


def test_bits_per_key_equals_reference():
    """The CN's bits a key (``src/repro/core/ludo.py:73-75``) of the same
    keys and geometry, equal as floats, from built and forced bucket
    counts; the reference's side built in a subprocess."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    ref = json.loads(subprocess.run(
        [sys.executable, "-c", REF_BITS, json.dumps(BITS_CASES)], env=env,
        capture_output=True, text=True, check=True, timeout=300).stdout)
    for (n, buckets), want in zip(BITS_CASES, ref):
        lo, hi = split_u64(make_uniform_keys(n))
        got = ludo.build(lanes(lo, "cpu"), lanes(hi, "cpu"),
                         num_buckets=buckets).cn
        assert [got.num_buckets, got.othello.bits] == want[:2], n
        assert got.bits_per_key == want[2], n
        assert 0 < got.bits_per_key < 64
