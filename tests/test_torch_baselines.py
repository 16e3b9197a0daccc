"""The port's four baselines against ``repro.core.baselines``, on the CPU.

The same keys and values (made from a seed with numpy) build a reference
engine and the port's (``device="cpu"``), and every comparison is exact:

* the built arrays (index, chain pointers, heap, sizes) are identical,
  and the device mirror equals the host image;
* ``get``, ``get_batch`` and ``mn_get_batch`` give the reference's values
  and matches bit for bit (a miss's value included), with identical meter
  snapshots — the cases of ``tests/test_core_baselines.py`` and
  ``tests/test_baseline_batch_parity.py``, each held against ``repro``;
* batched mutations equal the scalar loop and the reference (results,
  meters, arrays), last write wins, and a lockstep run started by
  ``from_reference`` stays equal through a mixed stream;
* the reference's batch approximations are reproduced, not fixed: RACE
  and MICA verify at most 3 fingerprint candidates, MICA's batch scans a
  4-bucket window (a far-displaced build key misses in ``get_batch`` but
  hits in ``get``), Cluster walks at most ``MAX_CHAIN`` buckets and
  verifies the first fingerprint hit of each;
* every ``RuntimeError`` of the reference is raised with its message, the
  lanes before it applied and the meter charged, and the device mirror
  still equals the host image after it.
"""

import numpy as np
import pytest
import torch

from repro.core import baselines as R
from repro.core.hashing import hash_range, split_u64, splitmix64
from repro.core.store import make_uniform_keys
from repro_torch.core import baselines as T
from repro_torch.core.hashing import to_u32_numpy
from repro_torch.core.outback import OutbackShard as TShard

N = 20_000
ABSENT = splitmix64(np.arange(1, 257, dtype=np.uint64) + np.uint64(1 << 45))
KINDS = ["RaceKVS", "MicaKVS", "ClusterKVS", "DummyKVS"]
VERIFYING = ["RaceKVS", "MicaKVS", "ClusterKVS"]
INDEX = ("fp", "addr", "nxt", "h_klo", "h_khi", "h_vlo", "h_vhi")
SIZES = ("ng", "nb", "cap", "free_top", "n", "heap_top", "n_keys")


@pytest.fixture(scope="module")
def data():
    keys = make_uniform_keys(N, 7)
    return keys, splitmix64(keys)


def _pair(name, keys, vals, **kw):
    return (getattr(R, name)(keys, vals, **kw),
            getattr(T, name)(keys, vals, device="cpu", **kw))


def _host(x) -> np.ndarray:
    """A batch output as the reference returns it (uint32 lanes, bools)."""
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.dtype == torch.bool else to_u32_numpy(x)
    return np.asarray(x)


def _same_batch(r_out, t_out):
    for a, b in zip(r_out, t_out):
        a, b = np.asarray(a), _host(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _assert_same_state(r, t):
    for name in INDEX:
        if hasattr(r, name):
            np.testing.assert_array_equal(np.asarray(getattr(r, name)),
                                          getattr(t, name), err_msg=name)
    for name in SIZES:
        if hasattr(r, name):
            assert int(getattr(r, name)) == int(getattr(t, name)), name
    assert r.meter.snapshot() == t.meter.snapshot()
    dev, host = t.device_image(), t.host_image()
    assert dev.keys() == host.keys()
    for k in host:
        np.testing.assert_array_equal(dev[k], host[k], err_msg=k)


@pytest.fixture(scope="module")
def built(data):
    keys, vals = data
    return {name: _pair(name, keys, vals) for name in KINDS}


# ------------------------------------------------------------------ build
@pytest.mark.parametrize("name", KINDS)
def test_build_arrays_identical(built, name):
    r, t = built[name]
    _assert_same_state(r, t)
    assert t.device.type == "cpu"
    assert all(x.device.type == "cpu" for x in t.mn_arrays())


@pytest.mark.parametrize("name,lf", [("RaceKVS", 0.75), ("MicaKVS", 0.95),
                                     ("ClusterKVS", 1.0), ("MicaKVS", 0.3)])
def test_build_identical_at_other_load_factors(name, lf):
    keys = make_uniform_keys(4096, 11)
    _assert_same_state(*_pair(name, keys, splitmix64(keys), load_factor=lf))


@pytest.mark.parametrize("name,lf,msg", [
    ("RaceKVS", 0.9, "RACE table full; lower load factor"),
    ("MicaKVS", 1.5, "MICA table full"),
    ("ClusterKVS", 1.5, "cluster chain arena full")])
def test_build_raises_as_reference(name, lf, msg):
    keys = make_uniform_keys(2048, 7)
    for pkg, kw in ((R, {}), (T, {"device": "cpu"})):
        with pytest.raises(RuntimeError) as e:
            getattr(pkg, name)(keys, splitmix64(keys), load_factor=lf, **kw)
        assert str(e.value) == msg


# ------------------------------------------------------------------- gets
@pytest.mark.parametrize("name", VERIFYING)
def test_get_correct(built, data, name):
    keys, vals = data
    r, t = built[name]
    for i in range(0, N, 997):
        assert t.get(int(keys[i])) == r.get(int(keys[i])) == int(vals[i])
    assert t.get(2**63 + 12345) is None and r.get(2**63 + 12345) is None
    assert r.meter.snapshot() == t.meter.snapshot()


@pytest.mark.parametrize("name", KINDS)
def test_get_batch_matches_reference(data, name):
    keys, vals = data
    r, t = _pair(name, keys, vals)
    q = np.concatenate([keys[:4096], ABSENT])
    _same_batch(r.get_batch(q), t.get_batch(q))
    assert r.meter.snapshot() == t.meter.snapshot()
    if name != "DummyKVS":  # dummy returns arbitrary blocks by design
        v_lo, v_hi, match = (_host(x) for x in t.get_batch(keys[:4096]))
        assert match.mean() > 0.999
        got = (v_hi.astype(np.uint64) << np.uint64(32)) | v_lo
        np.testing.assert_array_equal(got[match], vals[:4096][match])


@pytest.mark.parametrize("name", VERIFYING)
def test_scalar_vs_batch_values_hits_and_misses(built, data, name):
    keys, vals = data
    _, t = built[name]
    q = np.concatenate([keys[:512], ABSENT])
    v_lo, v_hi, match = (_host(x) for x in t.get_batch(q))
    got = (v_hi.astype(np.uint64) << np.uint64(32)) | v_lo
    for i, k in enumerate(q):
        scalar = t.get(int(k))
        if i < 512:
            assert match[i] and scalar == int(vals[i]) == int(got[i])
        else:
            assert scalar is None and not match[i]


def _mn_inputs(r, q):
    lo, hi = split_u64(q)
    if isinstance(r, R.MicaKVS):
        return (hash_range(lo, hi, 0x111CA, r.nb).astype(np.int32),
                R.RaceKVS._fp(lo, hi), lo, hi)
    return (hash_range(lo, hi, 0xC1C1, r.nb).astype(np.int32),
            R.ClusterKVS._fp14(lo, hi), lo, hi)


def _tensor(x):
    return torch.from_numpy(np.asarray(x).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("name", ["MicaKVS", "ClusterKVS"])
def test_mn_get_batch_matches_reference(built, data, name):
    """The isolated MN scan (what the MN-thread measurements time) gives
    the reference's answers, and what the full batched path gives."""
    keys, _ = data
    r, t = built[name]
    q = np.concatenate([keys[:1024], ABSENT])
    b, fp, lo, hi = _mn_inputs(r, q)
    r_arrays = ((r.fp, r.addr, r.h_klo, r.h_khi, r.h_vlo, r.h_vhi)
                if name == "MicaKVS" else
                (r.fp, r.addr, r.nxt, r.h_klo, r.h_khi, r.h_vlo, r.h_vhi))
    want = r.mn_get_batch(b, fp, lo, hi, r_arrays)
    got = t.mn_get_batch(torch.from_numpy(b), _tensor(fp), _tensor(lo),
                         _tensor(hi), t.mn_arrays())
    _same_batch(want, got)
    full = t.get_batch(q)
    _same_batch([_host(x) for x in full], got)
    ok = _host(got[2])
    assert ok[:1024].all() and not ok[1024:].any()


def test_dummy_mn_get_batch_matches_reference(built, data):
    keys, _ = data
    r, t = built["DummyKVS"]
    idx = (keys[:1000] % np.uint64(N)).astype(np.int32)
    idx[::7] -= np.int32(N)  # negative indices wrap as numpy's %
    want = r.mn_get_batch(idx, (r.h_vlo, r.h_vhi))
    got = t.mn_get_batch(torch.from_numpy(idx), t.mn_arrays())
    _same_batch(want, got)


def test_race_has_no_mn_scan(built):
    _, t = built["RaceKVS"]
    with pytest.raises(NotImplementedError, match="one-sided"):
        t.mn_get_batch(None, None, None, None, t.mn_arrays())


@pytest.mark.parametrize("name", KINDS)
def test_device_steps_compose_the_batched_get(built, data, name):
    """``query`` then the device step (``mn_get_batch``, RACE's
    ``cn_select``) is ``get_batch``; ``arrays=`` takes the device tuple."""
    keys, _ = data
    _, t = built[name]
    q = np.concatenate([keys[:256], ABSENT[:16]])
    want = [_host(x) for x in t.get_batch(q)]
    step = t.cn_select if name == "RaceKVS" else t.mn_get_batch
    _same_batch(want, step(*t.query(q), t.mn_arrays()))
    _same_batch(want, t.get_batch(q, arrays=t.mn_arrays()))


@pytest.mark.parametrize("name,rts", [("RaceKVS", 2), ("MicaKVS", 1),
                                      ("ClusterKVS", 1), ("DummyKVS", 1)])
def test_meter_counts_scalar_equals_batch(data, name, rts):
    keys, vals = data
    r, t = _pair(name, keys, vals)
    for kvs in (r, t):
        kvs.meter.reset()
        kvs.get_batch(keys[:1024])
    batch = t.meter.per_op()
    assert batch["round_trips"] == rts
    assert r.meter.snapshot() == t.meter.snapshot()
    for kvs in (r, t):
        kvs.meter.reset()
    hits = 0
    for k in keys[:256]:
        hits += t.get(int(k)) is not None
        r.get(int(k))
    scalar = t.meter.per_op()
    assert hits == 256 and r.meter.snapshot() == t.meter.snapshot()
    assert scalar["round_trips"] == pytest.approx(rts, abs=0.1)
    if name == "RaceKVS":
        assert batch["req_bytes"] == 32 and batch["resp_bytes"] == 160
        assert scalar["mn_cmp_ops"] == batch["mn_cmp_ops"] == 0
    elif name != "DummyKVS":
        assert batch["req_bytes"] == 64 and batch["resp_bytes"] == 64
        assert (scalar["mn_cmp_ops"] > 0) == (batch["mn_cmp_ops"] > 0)


def test_round_trip_and_mn_compute_orderings(data):
    """Outback 1 RT with no MN index compute; RPC baselines 1 RT with MN
    compares; RACE 2 RTs and more bytes back than Outback."""
    keys, vals = data
    out = TShard(keys, vals, load_factor=0.85, device="cpu")
    race, mica, clus = (getattr(T, n)(keys, vals, device="cpu")
                        for n in ("RaceKVS", "MicaKVS", "ClusterKVS"))
    for kvs in (out, race, mica, clus):
        kvs.meter.reset()
        kvs.get_batch(keys[:1024])
    assert out.meter.per_op()["round_trips"] == 1
    assert mica.meter.per_op()["round_trips"] == 1
    assert race.meter.per_op()["round_trips"] == 2
    assert out.meter.mn_cmp_ops == 0 and out.meter.mn_hash_ops == 0
    assert mica.meter.mn_cmp_ops > 0 and clus.meter.mn_cmp_ops > 0
    assert race.meter.resp_bytes > out.meter.resp_bytes


# ------------------------------------------------- batched mutation parity
def _mutation_script(keys):
    """(kind, keys, values) steps mixing hits, misses, duplicate keys in
    one batch, re-inserts of live keys, and delete-then-reinsert."""
    fresh = splitmix64(np.arange(1, 129, dtype=np.uint64)
                       + np.uint64(1 << 47))
    dup = np.concatenate([keys[:64], keys[:64]])
    return [
        ("update", keys[:256], splitmix64(keys[:256] + np.uint64(1))),
        ("update", ABSENT[:64], splitmix64(ABSENT[:64])),
        ("update", dup, splitmix64(dup + np.uint64(2))),
        ("delete", keys[256:384], None),
        ("delete", np.concatenate([keys[300:332], keys[300:332]]), None),
        ("insert", fresh, splitmix64(fresh)),
        ("insert", keys[256:320], splitmix64(keys[256:320])),
        ("insert", np.concatenate([fresh[:16], fresh[:16]]) + np.uint64(1),
         splitmix64(np.arange(32, dtype=np.uint64))),
        ("update", keys[256:384], splitmix64(keys[256:384] + np.uint64(3))),
    ]


def _apply_batched(kvs, step):
    kind, ks, vs = step
    if kind == "update":
        return [bool(x) for x in kvs.update_batch(ks, vs)]
    if kind == "delete":
        return [bool(x) for x in kvs.delete_batch(ks)]
    return list(kvs.insert_batch(ks, vs))


def _apply_scalar(kvs, step):
    kind, ks, vs = step
    if kind == "update":
        return [bool(kvs.update(int(k), int(v))) for k, v in zip(ks, vs)]
    if kind == "delete":
        return [bool(kvs.delete(int(k))) for k in ks]
    return [kvs.insert(int(k), int(v)) for k, v in zip(ks, vs)]


@pytest.mark.parametrize("name", KINDS)
def test_batched_mutations_match_scalar_loop_and_reference(data, name):
    keys, vals = data
    # headroom for the script's fresh inserts (the displacement / chain
    # bounds are the engines' capacity contract, not parity's)
    r, batched = _pair(name, keys, vals, load_factor=0.5)
    scalar = getattr(T, name)(keys, vals, load_factor=0.5, device="cpu")
    for step in _mutation_script(keys):
        want = _apply_batched(r, step)
        assert _apply_batched(batched, step) == want, step[0]
        assert _apply_scalar(scalar, step) == want, step[0]
        _assert_same_state(r, batched)
        _assert_same_state(r, scalar)
    q = np.concatenate([keys[:384], ABSENT[:64]])
    want = r.get_batch(q)
    _same_batch(want, batched.get_batch(q))
    _same_batch(want, scalar.get_batch(q))
    if name != "DummyKVS":
        ok = _host(batched.get_batch(q)[2])
        assert ok[:256].all() and ok[256:320].all()
        assert not ok[320:384].any() and not ok[384:].any()


@pytest.mark.parametrize("name", VERIFYING)
def test_batched_mutations_last_write_wins_in_offer_order(data, name):
    keys, vals = data
    r, t = _pair(name, keys, vals)
    k = keys[:32]
    dup = np.concatenate([k, k, k])
    v = np.concatenate([splitmix64(k + np.uint64(10)),
                        splitmix64(k + np.uint64(20)),
                        splitmix64(k + np.uint64(30))])
    assert np.asarray(t.update_batch(dup, v)).all()
    r.update_batch(dup, v)
    for i, key in enumerate(k):
        assert t.get(int(key)) == r.get(int(key)) == int(v[64 + i])
    _assert_same_state(r, t)


@pytest.mark.parametrize("name", KINDS)
def test_from_reference_lockstep_through_a_mixed_stream(data, name):
    """A port engine adopted from a reference engine mid-run stays equal
    to it through Gets, updates, inserts, deletes, scalar and batched."""
    keys, vals = data
    r = getattr(R, name)(keys, vals, load_factor=0.5)
    r.update_batch(keys[:100], keys[:100])
    r.delete_batch(keys[100:150])
    t = getattr(T, name).from_reference(r, device="cpu")
    r.meter.reset()
    _assert_same_state(r, t)
    rng = np.random.default_rng(5)
    fresh = splitmix64(np.arange(1, 2001, dtype=np.uint64)
                       + np.uint64(5 << 44))
    for step in range(12):
        q = keys[rng.integers(0, N, 300)]
        _same_batch(r.get_batch(q), t.get_batch(q))
        u = keys[rng.integers(0, N, 64)]
        assert _apply_batched(r, ("update", u, u + np.uint64(step))) == \
            _apply_batched(t, ("update", u, u + np.uint64(step)))
        f = fresh[step * 100:(step + 1) * 100]
        assert _apply_batched(r, ("insert", f, f)) == \
            _apply_batched(t, ("insert", f, f))
        d = np.concatenate([keys[rng.integers(0, N, 16)], f[:8]])
        assert _apply_batched(r, ("delete", d, None)) == \
            _apply_batched(t, ("delete", d, None))
        k = int(keys[rng.integers(0, N)])
        assert (r.get(k), r.update(k, step), r.delete(k),
                r.insert(k, step)) == \
            (t.get(k), t.update(k, step), t.delete(k), t.insert(k, step))
        _assert_same_state(r, t)
    heap = t.h_klo.shape[0]
    assert name == "DummyKVS" or heap > N  # inserts grew the heap


# ---------------------------------------------- the pinned approximations
def _keys_where(pred, count, offset):
    """The first ``count`` keys of a seeded stream satisfying ``pred``."""
    cand = splitmix64(np.arange(1, 1 << 18, dtype=np.uint64)
                      + np.uint64(offset << 40))
    lo, hi = split_u64(cand)
    sel = cand[pred(lo, hi)][:count]
    assert sel.size == count
    return sel


def _misses_in_batch_only(r, t, keys, vals):
    """Keys the batch misses but ``get`` finds, identical in both."""
    want = r.get_batch(keys)
    got = t.get_batch(keys)
    _same_batch(want, got)
    miss = ~_host(got[2])
    for i in np.nonzero(miss)[0]:
        assert t.get(int(keys[i])) == r.get(int(keys[i])) == int(vals[i])
    assert r.meter.snapshot() == t.meter.snapshot()
    return miss


def test_race_batch_verifies_at_most_three_candidates():
    """Eight build keys of one fingerprint in a 2-group table: a key behind
    3 same-fingerprint lanes misses in the batch, hits in ``get``."""
    keys = _keys_where(lambda lo, hi: R.RaceKVS._fp(lo, hi) == 7, 8, 3)
    vals = splitmix64(keys)
    r, t = _pair("RaceKVS", keys, vals)
    assert t.ng == 2
    assert _misses_in_batch_only(r, t, keys, vals).sum() >= 1


def test_mica_batch_scans_a_four_bucket_window():
    """At load factor 0.95 some build keys sit past the scan window."""
    keys = make_uniform_keys(2048, 7)
    vals = splitmix64(keys)
    r, t = _pair("MicaKVS", keys, vals, load_factor=0.95)
    assert _misses_in_batch_only(r, t, keys, vals).sum() > 0


def test_cluster_batch_walks_at_most_max_chain_buckets():
    """Twenty build keys homed at bucket 0 fill a chain of five buckets:
    the fifth is past the batch's ``MAX_CHAIN`` walk."""
    n, lf = 64, 0.8
    nb = int(np.ceil(n / (4 * lf)))
    home = _keys_where(lambda lo, hi: hash_range(lo, hi, 0xC1C1, nb) == 0,
                       21, 4)
    other = _keys_where(lambda lo, hi: hash_range(lo, hi, 0xC1C1, nb) != 0,
                        n - 20, 5)
    keys = np.concatenate([home[:20], other])
    vals = splitmix64(keys)
    r, t = _pair("ClusterKVS", keys, vals, load_factor=lf)
    _assert_same_state(r, t)
    miss = _misses_in_batch_only(r, t, keys, vals)
    assert miss[16:20].all() and not miss[:16].any()
    # a runtime insert homed there walks past MAX_CHAIN - 1 hops
    for kvs in (r, t):
        with pytest.raises(RuntimeError,
                           match="^cluster chain bound exceeded$"):
            kvs.insert(int(home[20]), 1)
    _assert_same_state(r, t)


# ---------------------------------------------------------- runtime raises
def _raise_in_batch(r, t, ks, message):
    """Both engines raise ``message`` on the same insert batch, with the
    lanes before it applied, the meter charged and the mirror in sync."""
    errs = []
    for kvs in (r, t):
        with pytest.raises(RuntimeError) as e:
            kvs.insert_batch(ks, splitmix64(ks))
        errs.append(str(e.value))
    assert errs == [message, message]
    assert t.meter.ops > 0
    _assert_same_state(r, t)


def test_race_fp_candidate_bound():
    base = make_uniform_keys(8, 7)
    fresh = _keys_where(lambda lo, hi: R.RaceKVS._fp(lo, hi) == 9, 6, 6)
    r, t = _pair("RaceKVS", base, splitmix64(base), load_factor=0.3)
    _raise_in_batch(r, t, fresh, "RACE fp-candidate bound: 3+ colliding "
                    "fingerprints in the candidate groups")


def test_race_both_groups_full():
    keys = make_uniform_keys(512, 7)
    r, t = _pair("RaceKVS", keys, splitmix64(keys))
    fresh = splitmix64(np.arange(1, 2001, dtype=np.uint64)
                       + np.uint64(3 << 44))
    _raise_in_batch(r, t, fresh, "RACE: both candidate groups full; lower "
                    "load factor")


def test_mica_displacement_bound():
    keys = make_uniform_keys(512, 7)
    r, t = _pair("MicaKVS", keys, splitmix64(keys))
    fresh = splitmix64(np.arange(1, 2001, dtype=np.uint64)
                       + np.uint64(3 << 44))
    _raise_in_batch(r, t, fresh, "MICA displacement bound: no free lane "
                    "within the 4-bucket scan window")


def test_mica_fp_candidate_bound():
    keys = make_uniform_keys(64, 7)
    nb = int(np.ceil(64 / (8 * 0.2)))
    fresh = _keys_where(lambda lo, hi: (hash_range(lo, hi, 0x111CA, nb) == 3)
                        & (R.RaceKVS._fp(lo, hi) == 5), 4, 7)
    r, t = _pair("MicaKVS", keys, splitmix64(keys), load_factor=0.2)
    _raise_in_batch(r, t, fresh, "MICA fp-candidate bound: 3+ colliding "
                    "fingerprints in the scan window")


def test_cluster_arena_full_and_fp_shadow():
    keys = make_uniform_keys(512, 7)
    r, t = _pair("ClusterKVS", keys, splitmix64(keys))
    fresh = splitmix64(np.arange(1, 2001, dtype=np.uint64)
                       + np.uint64(3 << 44))
    _raise_in_batch(r, t, fresh, "cluster chain arena full")
    keys = make_uniform_keys(64, 7)
    nb = int(np.ceil(64 / (4 * 0.3)))
    homed = _keys_where(lambda lo, hi: hash_range(lo, hi, 0xC1C1, nb) == 2,
                        2000, 8)
    fps = R.ClusterKVS._fp14(*split_u64(homed))
    _, first, counts = np.unique(fps, return_index=True, return_counts=True)
    twin = fps[first[np.argmax(counts > 1)]]
    fresh = homed[fps == twin][:2]  # same bucket, same fingerprint
    r, t = _pair("ClusterKVS", keys, splitmix64(keys), load_factor=0.3)
    _raise_in_batch(r, t, fresh, "cluster fp-shadow bound: colliding "
                    "fingerprint earlier in the bucket")


def test_device_grows_with_the_host_heap(data):
    """The build's heap is exactly n long: the first insert grows it to
    1.5n + 64 on the host, and the device follows before the next Get."""
    keys, vals = data
    r, t = _pair("MicaKVS", keys, vals, load_factor=0.5)
    fresh = ABSENT[:8]
    assert t.t_klo.shape[0] == N
    assert list(t.insert_batch(fresh, fresh)) == \
        list(r.insert_batch(fresh, fresh))
    assert t.t_klo.shape[0] == t.h_klo.shape[0] == int(N * 1.5) + 64
    _assert_same_state(r, t)
    _same_batch(r.get_batch(fresh), t.get_batch(fresh))
