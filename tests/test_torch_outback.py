"""Port vs reference: one Outback shard answers and meters identically.

The same keys, values and op streams (made from seeds with numpy) go
through ``repro.core.outback.OutbackShard`` and the port's shard on
``device="cpu"``.  Exact equality everywhere — the path is integer-only:
per-lane answers and statuses, the final MN image (``mn_state``), the CN's
cached seeds and ``CommMeter.snapshot()``.  Heavy overflow and Makeup-Get
pressure mirrors ``tests/test_makeup_batch.py``; the shuffled write mixes
mirror ``tests/test_write_batch_parity.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.hashing import split_u64, splitmix64
from repro.core.outback import OutbackShard as RShard
from repro.core.store import make_uniform_keys
from repro_torch.core.outback import OutbackShard as TShard
from repro_torch.kernels import ops

N = 4000


def _pair(keys, vals, **kw):
    return RShard(keys, vals, **kw), TShard(keys, vals, device="cpu", **kw)


def _host(x):
    """An engine output (numpy, or an int32 bit-pattern / bool tensor) as
    comparable host numpy."""
    if isinstance(x, torch.Tensor):
        a = x.numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a
    a = np.asarray(x)
    return a.astype(np.uint32) if a.dtype.kind in "iu" else a


def _assert_same(r, t):
    a, b = r.mn_state(), t.mn_state()
    assert a.keys() == b.keys()
    for k in a:
        if k == "overflow":
            for kk in a[k]:
                np.testing.assert_array_equal(a[k][kk], b[k][kk], err_msg=kk)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    np.testing.assert_array_equal(r.cn.seeds, t.cn.seeds.numpy())
    assert r.meter.snapshot() == t.meter.snapshot()
    assert (r.n_keys, r.heap_top) == (t.n_keys, t.heap_top)


def _assert_same_get(r_out, t_out):
    for x, y in zip(r_out, t_out):
        np.testing.assert_array_equal(_host(x), _host(y))


def _mix(n_ops, seed, keys, n_new=3000):
    """A shuffled insert/update/delete mix (existing, fresh + repeat keys)."""
    rng = np.random.default_rng(seed)
    new = splitmix64(np.arange(1, n_new + 1, dtype=np.uint64)
                     + np.uint64(77 << 40))
    out = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.35:
            out.append(("u", int(keys[rng.integers(keys.size)]),
                        int(rng.integers(1 << 62))))
        elif r < 0.65:
            out.append(("i", int(new[rng.integers(n_new)]),
                        int(rng.integers(1 << 62))))
        elif r < 0.85:
            out.append(("d", int(keys[rng.integers(keys.size)]), 0))
        else:  # deletes of maybe-absent keys (repeat-delete path)
            out.append(("d", int(new[rng.integers(n_new)]), 0))
    return out


def _runs(stream):
    """Consecutive same-type ops grouped, as a doorbell window does."""
    i = 0
    while i < len(stream):
        j = i
        while j < len(stream) and stream[j][0] == stream[i][0]:
            j += 1
        yield (stream[i][0], np.asarray([o[1] for o in stream[i:j]], np.uint64),
               np.asarray([o[2] for o in stream[i:j]], np.uint64))
        i = j


def _apply_batched(sh, stream):
    out = []
    for op, ks, vs in _runs(stream):
        if op == "u":
            out += np.asarray(sh.update_batch(ks, vs)).tolist()
        elif op == "i":
            out += list(sh.insert_batch(ks, vs))
        else:
            out += np.asarray(sh.delete_batch(ks)).tolist()
    return out


def _apply_scalar(sh, stream):
    out = []
    for op, k, v in stream:
        if op == "u":
            out.append(bool(sh.update(k, v)))
        elif op == "i":
            out.append(sh.insert(k, v))
        else:
            out.append(bool(sh.delete(k)))
    return out


def _pressured(shard_cls, **kw):
    """A shard driven past the §4.4 ``s_slow`` trigger: tight table, small
    overflow cache, then fresh inserts until overflow pressure is real."""
    keys = make_uniform_keys(N, 7)
    sh = shard_cls(keys, splitmix64(keys), load_factor=0.95,
                   overflow_frac=0.05, rng_seed=3, **kw)
    cases = []
    for k in _FRESH:
        if sh.must_stop():
            break
        cases.append(sh.insert(int(k), int(splitmix64(np.uint64([k]))[0])))
    return sh, keys, cases


_FRESH = splitmix64(np.arange(1, 600, dtype=np.uint64) + np.uint64(9 << 40))
_ABSENT = splitmix64(np.arange(1, 64, dtype=np.uint64) + np.uint64(1 << 45))


@pytest.fixture(scope="module")
def pressured():
    r, keys, r_cases = _pressured(RShard)
    t, _, t_cases = _pressured(TShard, device="cpu")
    assert r_cases == t_cases
    assert {"slot", "reseed", "overflow"} <= set(r_cases)
    return r, t, keys


# ------------------------------------------------------------------ build
@pytest.mark.parametrize("n,kw", [(1, {}), (5, {}), (16, {"num_buckets": 4}),
                                  (1000, {"load_factor": 0.9}),
                                  (12_000, {"rng_seed": 5})])
def test_build_gives_the_reference_mn_image(n, kw):
    keys = make_uniform_keys(n, 2)
    r, t = _pair(keys, splitmix64(keys), **kw)
    _assert_same(r, t)
    for dev_arr in (t.slots_lo, t.heap_klo, t.cn.othello.words_a):
        assert dev_arr.dtype == torch.int32 and dev_arr.device.type == "cpu"
    assert t.seeds_mn.dtype == t.cn.seeds.dtype == torch.uint8
    assert (r.cn_memory_bytes(), r.mn_index_bytes(), r.mn_state_bytes()) == \
        (t.cn_memory_bytes(), t.mn_index_bytes(), t.mn_state_bytes())


# --------------------------------------------------------------- scalar ops
@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_protocol_walks_match(seed):
    keys = make_uniform_keys(3000, 4)
    r, t = _pair(keys, splitmix64(keys), load_factor=0.92)
    stream = _mix(700, seed, keys)
    assert _apply_scalar(r, stream) == _apply_scalar(t, stream)
    _assert_same(r, t)
    rng = np.random.default_rng(seed)
    q = np.concatenate([keys[rng.integers(0, keys.size, 200)], _ABSENT[:20],
                        np.asarray([o[1] for o in stream[:100]], np.uint64)])
    for k in q:
        a, b = r.get(int(k)), t.get(int(k))
        assert (a.value, a.round_trips, a.makeup) == \
            (b.value, b.round_trips, b.makeup)
    _assert_same(r, t)


# -------------------------------------------------------------- batched ops
@pytest.mark.parametrize("seed", [3, 11])
def test_batched_write_mix_matches_reference(seed):
    keys = make_uniform_keys(6000, 5)
    vals = splitmix64(keys)
    r, t = _pair(keys, vals, load_factor=0.88)
    stream = _mix(900, seed, keys)
    assert _apply_batched(r, stream) == _apply_batched(t, stream)
    _assert_same(r, t)
    # the port's batched ops are the port's scalar walks, too
    t2 = TShard(keys, vals, load_factor=0.88, device="cpu")
    _apply_scalar(t2, stream)
    _assert_same(r, t2)


@pytest.mark.parametrize("resolve", [False, True])
def test_get_batch_matches_reference(resolve):
    keys = make_uniform_keys(N, 3)
    r, t = _pair(keys, splitmix64(keys), load_factor=0.9)
    stream = _mix(500, 2, keys)
    _apply_batched(r, stream)
    _apply_batched(t, stream)
    q = np.concatenate([keys[:1500], _ABSENT,
                        np.asarray([o[1] for o in stream], np.uint64)])
    _assert_same_get(r.get_batch(q, resolve_makeup=resolve),
                     t.get_batch(q, resolve_makeup=resolve))
    _assert_same(r, t)


def test_scalar_and_batched_get_meter_identically():
    keys = make_uniform_keys(N, 3)
    q = np.concatenate([keys[:192], _ABSENT])
    _, a = _pair(keys, splitmix64(keys), load_factor=0.9)
    b = TShard(keys, splitmix64(keys), load_factor=0.9, device="cpu")
    for k in q:
        a.get(int(k))
    b.get_batch(q, resolve_makeup=True)
    assert a.meter.snapshot() == b.meter.snapshot()


def test_duplicate_lanes_resolve_in_lane_order():
    keys = make_uniform_keys(256, 8)
    r, t = _pair(keys, splitmix64(keys), load_factor=0.8)
    k = keys[5]
    for sh in (r, t):
        assert sh.update_batch(np.asarray([k, k, k], np.uint64),
                               np.asarray([1, 2, 3], np.uint64)).all()
        assert sh.get(int(k)).value == 3
        assert sh.delete_batch(np.asarray([keys[7]] * 2, np.uint64)).tolist() \
            == [True, False]
        assert sh.get(int(keys[7])).value is None
    _assert_same(r, t)


def test_insert_batch_grows_the_heap_like_the_reference():
    """One insert batch that outgrows the heap several times, with keys
    repeated inside it: the heap ends at the reference's capacity and the
    repeats resolve to updates of blocks written earlier in the batch."""
    keys = make_uniform_keys(300, 12)
    r, t = _pair(keys, splitmix64(keys), load_factor=0.5, overflow_frac=1.0,
                 heap_cap=310)
    fresh = _FRESH[:500]
    ik = np.concatenate([fresh, fresh[::7], keys[:20]])
    iv = np.arange(1, ik.size + 1, dtype=np.uint64)
    assert r.insert_batch(ik, iv) == t.insert_batch(ik, iv)
    assert t.heap_klo.shape[0] > 2 * 310  # grew twice in the batch
    _assert_same(r, t)
    _assert_same_get(r.get_batch(ik, resolve_makeup=True),
                     t.get_batch(ik, resolve_makeup=True))


def test_insert_batch_past_s_stop_raises_like_the_reference():
    """A batch that fills the overflow cache raises mid-batch; the lanes
    before the failing one stay applied, as in the reference."""
    keys = make_uniform_keys(N, 7)
    r, t = _pair(keys, splitmix64(keys), load_factor=0.95,
                 overflow_frac=0.01, rng_seed=3)
    for sh in (r, t):
        with pytest.raises(Exception, match="s_stop") as err:
            sh.insert_batch(_FRESH, splitmix64(_FRESH))
        assert type(err.value).__name__ == "ShardFullError"
    _assert_same(r, t)


def test_frozen_shard_rejects_writes_like_the_reference():
    keys = make_uniform_keys(500, 8)
    r, t = _pair(keys, splitmix64(keys))
    r.frozen = t.frozen = True
    fresh = _FRESH[:4]
    assert r.insert_batch(fresh, fresh) == t.insert_batch(fresh, fresh)
    assert r.insert(int(fresh[0]), 1) == t.insert(int(fresh[0]), 1) == "frozen"
    np.testing.assert_array_equal(r.delete_batch(keys[:4]),
                                  t.delete_batch(keys[:4]))
    _assert_same(r, t)


# ------------------------------------------------ overflow / makeup pressure
def test_pressured_shards_stay_identical(pressured):
    r, t, _ = pressured
    assert t.overflow.size > 20 and t.needs_resize()
    _assert_same(r, t)


def test_overflow_lookup_batch_matches_reference(pressured):
    r, t, keys = pressured
    q = np.concatenate([keys[:800], _FRESH[:400], _ABSENT])
    lo, hi = split_u64(q)
    for a, b in zip(r.overflow.lookup_batch(lo, hi),
                    t.overflow.lookup_batch(lo, hi)):
        np.testing.assert_array_equal(a, b)


def test_makeup_wave_matches_reference():
    r, keys, _ = _pressured(RShard)
    t, _, _ = _pressured(TShard, device="cpu")
    q = np.concatenate([keys[:800], _FRESH[:400], _ABSENT])
    raw = t.get_batch(q, resolve_makeup=False)
    assert int((~raw[2]).sum()) > 200, "sized for a real makeup wave"
    _assert_same_get(r.get_batch(q, resolve_makeup=False), raw)
    _assert_same_get(r.get_batch(q, resolve_makeup=True),
                     t.get_batch(q, resolve_makeup=True))
    _assert_same(r, t)
    # a skip mask that covers every lane resolves nothing and spends nothing
    before = t.meter.snapshot()
    out = t._resolve_makeups(q, *raw, skip=torch.ones(q.size, dtype=torch.bool))
    assert t.meter.snapshot() == before
    assert torch.equal(out[2], raw[2])


def test_writes_under_pressure_match_reference():
    r, keys, _ = _pressured(RShard)
    t, _, _ = _pressured(TShard, device="cpu")
    rng = np.random.default_rng(0)
    q = np.concatenate([keys[:800], _FRESH[:400], _ABSENT])
    uk = q[rng.integers(0, q.size, 500)]
    uv = rng.integers(0, 1 << 62, 500, dtype=np.uint64)
    np.testing.assert_array_equal(r.update_batch(uk, uv), t.update_batch(uk, uv))
    dk = q[rng.integers(0, q.size, 300)]
    np.testing.assert_array_equal(r.delete_batch(dk), t.delete_batch(dk))
    ik = np.concatenate([dk[:100], _FRESH[300:310]])
    iv = rng.integers(0, 1 << 62, ik.size, dtype=np.uint64)
    assert r.insert_batch(ik, iv) == t.insert_batch(ik, iv)
    for k in q[::11]:
        assert r.update(int(k), 5) == t.update(int(k), 5)
        assert r.delete(int(k)) == t.delete(int(k))
    _assert_same(r, t)
    _assert_same_get(r.get_batch(q, resolve_makeup=True),
                     t.get_batch(q, resolve_makeup=True))
    rk, rv = r.live_pairs()
    tk, tv = t.live_pairs()
    np.testing.assert_array_equal(rk, tk)
    np.testing.assert_array_equal(rv, tv)


# ------------------------------------------------------ carrying state over
def _cn_dict(r):
    oth = r.cn.othello
    return dict(words_a=oth.words_a, words_b=oth.words_b, ma=oth.ma,
                mb=oth.mb, seed_a=oth.seed_a, seed_b=oth.seed_b,
                seeds=r.cn.seeds, num_buckets=r.cn.num_buckets)


def test_from_reference_arrays_answers_as_the_source_shard(pressured):
    src, _, keys = pressured
    r, _, _ = _pressured(RShard)  # an identical twin to keep driving
    t = TShard.from_reference_arrays(_cn_dict(src), src.mn_state(),
                                     device="cpu")
    t.meter.merge(src.meter)  # carry the totals so snapshots compare
    _assert_same(r, t)
    q = np.concatenate([keys[:800], _FRESH[:400], _ABSENT])
    _assert_same_get(r.get_batch(q, resolve_makeup=True),
                     t.get_batch(q, resolve_makeup=True))
    # the overflow cache is at s_stop: drive updates and deletes only
    stream = [o for o in _mix(400, 9, keys) if o[0] != "i"]
    assert _apply_batched(r, stream) == _apply_batched(t, stream)
    _assert_same(r, t)


def test_mn_state_installs_across_packages():
    keys = make_uniform_keys(2000, 6)
    r, t = _pair(keys, splitmix64(keys))
    stream = _mix(300, 4, keys)
    _apply_batched(t, stream)
    r.install_mn_state(t.mn_state())  # the port's image, into the reference
    _apply_batched(r2 := RShard(keys, splitmix64(keys)), stream)
    for k, v in r2.mn_state().items():
        if k != "overflow":
            np.testing.assert_array_equal(r.mn_state()[k], v, err_msg=k)
    with pytest.raises(ValueError):
        t.install_mn_state(RShard(keys[:100], keys[:100]).mn_state())


def test_cpu_shard_launches_no_kernel():
    ops.reset_launch_counts()
    keys = make_uniform_keys(500, 1)
    t = TShard(keys, splitmix64(keys), device="cpu")
    t.get_batch(keys, resolve_makeup=True)
    t.update_batch(keys[:10], keys[:10])
    assert ops.LAUNCHES == {"ludo_lookup": 0, "slot_unpack": 0}
