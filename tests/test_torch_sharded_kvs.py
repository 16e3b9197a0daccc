"""The port's mesh engine (``repro_torch.core.sharded_kvs``) against
``repro.core.sharded_kvs``, exactly.

* ``build_sharded``'s stacked arrays and geometry equal the reference's
  at (num_shards, data_parallel) = (1, 1), (2, 1) and (4, 2), and a heap
  row that overflows raises the same ``ValueError``;
* ``bin_by`` / ``take`` / ``unbin`` equal ``jnp``'s, with targets past the
  bins and capacity drops;
* an in-process (1, 1) gloo world gives the reference's output lanes on
  ``jax.make_mesh((1, 1))`` for both variants, with and without a CN cache
  replica, and with a transport the same meter snapshot and trace (the
  cases of ``test_net_sim.py::test_sharded_mesh_rides_the_clock`` and
  ``test_cn_cache.py::test_sharded_get_with_cache_single_device``);
  sentinel and absent keys among the lanes, every lane compared;
* spawned gloo worlds at (1, 2), (2, 2) and (2, 4) (one subprocess a rank,
  ``tests/_torch_mesh_rank.py``, a ``file://`` rendezvous) against the
  reference run in one subprocess over 8 host devices: the ranks' outputs
  concatenated in rank order equal the reference's lane for lane, for
  both variants; at (2, 4) also with the cache and with a skewed batch at
  ``capacity_slack=1.0``, whose capacity drops are compared;
* keys in a shard's overflow cache miss on the mesh path (it runs no
  Makeup-Get) while the adapter's protocol finds them, in both packages;
* ``ShardedKVSState.from_reference`` carries a reference state across and
  the two packages answer in lockstep.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import repro.net as rnet
from repro import api as r_api
from repro.core import sharded_kvs as R
from repro.core.cn_cache import CNKeyCache as RCache
from repro.core.cn_cache import ShardedCNCache as RSharded
from repro.core.hashing import split_u64, splitmix64
from repro.core.store import make_uniform_keys
import repro_torch.net as tnet
from repro_torch import api as t_api
from repro_torch.core import sharded_kvs as T
from repro_torch.core.cn_cache import CNKeyCache as TCache
from repro_torch.core.cn_cache import ShardedCNCache as TSharded
from repro_torch.core.hashing import hash64_32_np

from _torch_mesh_rank import warm_cache

ROOT = Path(__file__).resolve().parents[1]
N = 20_000
BATCH = 2048
ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(scope="module")
def data():
    keys = make_uniform_keys(N)
    return keys, splitmix64(keys)


def _queries(keys, size, seed):
    """``size`` lanes of stored keys with a few absent keys and the
    all-ones sentinel key among them."""
    q = keys[np.random.default_rng(seed).integers(0, keys.size, size)]
    q[3:7] = splitmix64(np.arange(4, dtype=np.uint64) + np.uint64(99 << 40))
    q[11] = q[-1] = ALL_ONES
    return q


def _u32(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 else x


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _trace(trace):
    return [(type(e).__name__, dataclasses.astuple(e)) for e in trace]


# ------------------------------------------------------------ the build
@pytest.mark.parametrize("num_shards,data_parallel", [(1, 1), (2, 1), (4, 2)])
def test_build_sharded_matches_reference(data, num_shards, data_parallel):
    keys, vals = data
    r = R.build_sharded(keys, vals, num_shards=num_shards,
                        data_parallel=data_parallel)
    t = T.build_sharded(keys, vals, num_shards=num_shards,
                        data_parallel=data_parallel)
    for a, b in zip(r.arrays(), t.arrays()):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert (r.num_buckets, r.heap_cap, r.ma, r.mb) == \
        (t.num_buckets, t.heap_cap, t.ma, t.mb)
    assert (r.index_bytes_cn(), r.index_bytes_mn()) == \
        (t.index_bytes_cn(), t.index_bytes_mn())
    assert t.meter is None and t.shards is None


def test_heap_row_overflow_raises_as_the_reference(data):
    keys, vals = data
    for mod in (R, T):
        with pytest.raises(ValueError, match="heap row overflow; raise "
                                             "heap_slack"):
            mod.build_sharded(keys[:4000], vals[:4000], num_shards=1,
                              data_parallel=2, heap_slack=0.3)


# ------------------------------------------------------- routing helpers
@pytest.mark.parametrize("B,nbins,cap,hi", [
    (128, 4, 64, 4),     # round trip, no drop
    (32, 2, 8, 1),       # one bin: 8 of 32 survive
    (200, 3, 16, 5),     # targets 3 and 4 never enter a bin, drops
    (64, 1, 128, 1),     # one bin larger than the batch
    (1000, 8, 40, 10),   # many bins, drops and out-of-range targets
])
def test_bin_take_unbin_match_jnp(B, nbins, cap, hi):
    tgt = np.random.default_rng(B + nbins).integers(0, hi, B).astype(np.int32)
    r_idx = np.asarray(R.bin_by(jnp.asarray(tgt), nbins, cap))
    t_idx = T.bin_by(torch.from_numpy(tgt), nbins, cap)
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(r_idx, t_idx.numpy())
    x = (np.arange(B, dtype=np.uint32) * np.uint32(2654435761))
    x2 = np.stack([x, ~x, x >> np.uint32(3), x + np.uint32(7)], -1)
    for arr, fill in ((x, 0xFFFFFFFF), (x2, 0xFFFFFFFF), (x, 0)):
        r_b = R.take(jnp.asarray(arr), jnp.asarray(r_idx), fill)
        t_b = T.take(_t(arr), t_idx, int(np.uint32(fill).view(np.int32)))
        np.testing.assert_array_equal(np.asarray(r_b), _u32(t_b))
        for out_fill in (0, 0xFFFFFFFF):
            r_u = R.unbin(jnp.asarray(r_idx), r_b, B, out_fill)
            t_u = T.unbin(t_idx, t_b, B,
                          int(np.uint32(out_fill).view(np.int32)))
            np.testing.assert_array_equal(np.asarray(r_u), _u32(t_u))
    kept = int((r_idx < B).sum())
    assert kept == sum(min(cap, int((tgt == b).sum())) for b in range(nbins))


# --------------------------------------------- the (1, 1) world, in process
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A one-rank gloo world for this module's in-process mesh tests."""
    rdv = tmp_path_factory.mktemp("world") / "rdv"
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        yield T.make_mesh((1, 1), device="cpu")
    finally:
        dist.destroy_process_group()


def _ref_run(st, q, variant, cache=None, bpd=None):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    arrays = R.place_state(mesh, st)
    extra = () if cache is None else R.place_cache(mesh, cache)
    fn, caps = R.make_get_fn(mesh, st, bpd or q.size, variant=variant,
                             cache=cache)
    qs = NamedSharding(mesh, P(("data", "model")))
    lo, hi = split_u64(q)
    out = fn(jax.device_put(jnp.asarray(lo), qs),
             jax.device_put(jnp.asarray(hi), qs), *extra, *arrays)
    return [np.asarray(x) for x in out], caps


def _port_run(mesh, st, q, variant, cache=None, bpd=None):
    blocks = T.place_state(mesh, st)
    extra = () if cache is None else T.place_cache(mesh, cache)
    fn, caps = T.make_get_fn(mesh, st, bpd or q.size, variant=variant,
                             cache=cache)
    lo, hi = split_u64(q)
    out = fn(_t(lo), _t(hi), *extra, *blocks)
    return [_u32(x) for x in out], caps


def _assert_same_lanes(r, t):
    assert len(r) == len(t)
    for a, b in zip(r, t):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", ["outback", "race"])
def test_mesh_get_matches_reference_single_rank(data, world, variant):
    keys, vals = data
    r_st = R.build_sharded(keys, vals, num_shards=1, data_parallel=1)
    t_st = T.build_sharded(keys, vals, num_shards=1, data_parallel=1)
    q = _queries(keys, BATCH, 3)
    r, r_caps = _ref_run(r_st, q, variant)
    t, t_caps = _port_run(world, t_st, q, variant)
    assert r_caps == t_caps
    _assert_same_lanes(r, t)
    lanes = q != ALL_ONES  # the sentinel key's lanes: compared above only
    stored = np.isin(q, keys)
    np.testing.assert_array_equal(t[2][lanes], stored[lanes])
    got = (t[1].astype(np.uint64) << np.uint64(32)) | t[0]
    np.testing.assert_array_equal(got[stored], splitmix64(q[stored]))


@pytest.mark.parametrize("variant", ["outback", "race"])
def test_mesh_rides_the_clock_as_the_reference(data, world, variant):
    """``build_sharded(transport=...)``: one meter event a Get lane, the
    same snapshot and the same trace as the reference's."""
    keys, vals = data
    r_tr, t_tr = rnet.Transport(), tnet.Transport()
    r_st = R.build_sharded(keys, vals, num_shards=1, data_parallel=1,
                           transport=r_tr)
    t_st = T.build_sharded(keys, vals, num_shards=1, data_parallel=1,
                           transport=t_tr)
    q = keys[np.random.default_rng(5).integers(0, N, 1024)]
    r, _ = _ref_run(r_st, q, variant, bpd=1024)
    t, _ = _port_run(world, t_st, q, variant, bpd=1024)
    _assert_same_lanes(r, t)
    assert t[2].all()
    assert len(t_tr) == 1024 and t_st.meter.ops == 1024
    assert r_st.meter.snapshot() == t_st.meter.snapshot()
    assert _trace(r_tr.trace) == _trace(t_tr.trace)
    rts = 2 if variant == "race" else 1
    assert all(len(e.segments) == rts for e in t_tr.trace
               if isinstance(e, tnet.OpEvent))
    res = tnet.simulate(t_tr.trace, clients=4)
    ref = rnet.simulate(r_tr.trace, clients=4)
    assert res.n_ops == 1024
    for f in dataclasses.fields(res):
        x, y = getattr(ref, f.name), getattr(res, f.name)
        assert np.array_equal(x, y) if isinstance(x, np.ndarray) \
            else x == y, f.name


def _caches(keys, n_warm, budget, ndev, seed=3):
    """The same warmed CN cache in both packages, as ``ndev`` replicas."""
    rng = np.random.default_rng(seed)
    warm = keys[rng.zipf(1.6, n_warm) % keys.size]
    r = warm_cache(RCache(budget), warm, splitmix64(warm))
    t = warm_cache(TCache(budget, device="cpu"), warm, splitmix64(warm))
    return RSharded(r, ndev), TSharded(t, ndev)


@pytest.mark.parametrize("variant", ["outback", "race"])
@pytest.mark.parametrize("metered", [False, True])
def test_mesh_get_with_cache_matches_reference(data, world, variant,
                                               metered):
    """The probe stage: hit lanes skip the bins, the hit mask and every
    lane as the reference's; with a transport the hits are metered as
    cache answers."""
    keys, vals = data
    trs = (rnet.Transport(), tnet.Transport()) if metered else (None, None)
    r_st = R.build_sharded(keys, vals, num_shards=1, data_parallel=1,
                           transport=trs[0])
    t_st = T.build_sharded(keys, vals, num_shards=1, data_parallel=1,
                           transport=trs[1])
    r_c, t_c = _caches(keys, 4096, 8 * N, 1)
    rng = np.random.default_rng(3)
    q = keys[rng.zipf(1.6, BATCH) % N]
    q[:4] = ALL_ONES
    r, _ = _ref_run(r_st, q, variant, cache=r_c)
    t, _ = _port_run(world, t_st, q, variant, cache=t_c)
    _assert_same_lanes(r, t)
    assert t[3].sum() > BATCH // 4 and t[2][4:].all()
    got = (t[1].astype(np.uint64) << np.uint64(32)) | t[0]
    np.testing.assert_array_equal(got[4:], splitmix64(q[4:]))
    if metered:
        assert r_st.meter.snapshot() == t_st.meter.snapshot()
        assert _trace(trs[0].trace) == _trace(trs[1].trace)


def test_place_cache_checks_the_replica_count(data, world):
    _, t_c = _caches(data[0], 256, 1 << 14, 4)
    with pytest.raises(ValueError, match="cache built for 4 devices, mesh "
                                         "has 1"):
        T.place_cache(world, t_c)


def test_make_mesh_checks_its_world(world):
    with pytest.raises(ValueError, match="needs 2 ranks"):
        T.make_mesh((1, 2), device="cpu")
    with pytest.raises(ValueError, match="mesh axes"):
        T.make_mesh((1, 1), ("model", "data"), device="cpu")
    with pytest.raises(RuntimeError, match="with gloo; the mesh needs nccl"):
        T.make_mesh((1, 1), device="cuda")  # no quiet gloo for the card
    assert (world.shape, world.coords, world.size) == \
        ({"data": 1, "model": 1}, (0, 0), 1)
    assert world.device == torch.device("cpu")


def test_place_state_checks_the_geometry(data, world):
    st = T.build_sharded(data[0][:4000], data[1][:4000], num_shards=2,
                         data_parallel=1)
    with pytest.raises(ValueError, match="2 shards"):
        T.place_state(world, st)


def test_overflow_residents_miss_on_the_mesh(world):
    """At a small n the build leaves keys in a shard's overflow cache: the
    mesh path (no Makeup-Get) misses them, in both packages, while the
    adapter's protocol finds them."""
    keys = make_uniform_keys(600, 11)
    vals = splitmix64(keys)
    spec = dict(kind="sharded", load_factor=1.0, params={"num_shards": 1})
    r_store = r_api.open_store(r_api.StoreSpec(**spec), keys, vals)
    t_store = t_api.open_store(t_api.StoreSpec(**spec), keys, vals,
                               device="cpu")
    sh = t_store.engine.shards[0]
    o_lo, o_hi, _ = sh.overflow.items()
    over = (np.asarray(o_hi, np.uint64) << np.uint64(32)) | \
        np.asarray(o_lo, np.uint64)
    assert over.size > 0
    r, _ = _ref_run(r_store.mesh_state(), keys, "outback")
    t, _ = _port_run(world, t_store.mesh_state(), keys,
                     "outback")
    _assert_same_lanes(r, t)
    np.testing.assert_array_equal(t[2], ~np.isin(keys, over))
    got = t_store.get_batch(keys)
    assert got.found.all() and np.array_equal(got.values, vals)


def test_from_reference_continues_in_lockstep(data, world):
    keys, vals = data
    r_tr, t_tr = rnet.Transport(), tnet.Transport()
    r_st = R.build_sharded(keys, vals, num_shards=1, data_parallel=1,
                           rng_seed=5, transport=r_tr)
    t_st = T.ShardedKVSState.from_reference(r_st, transport=t_tr)
    for a, b in zip(r_st.arrays(), t_st.arrays()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and not np.shares_memory(a, b)
    assert t_st.shards is None
    for step in range(3):
        q = _queries(keys, 512, step)
        variant = ("outback", "race")[step % 2]
        r, _ = _ref_run(r_st, q, variant)
        t, _ = _port_run(world, t_st, q, variant)
        _assert_same_lanes(r, t)
    assert r_st.meter.snapshot() == t_st.meter.snapshot()
    assert _trace(r_tr.trace) == _trace(t_tr.trace)


# ------------------------------------------------ spawned multi-rank worlds
MESHES = [(1, 2), (2, 2), (2, 4)]
MESH_KEYS = 8192
MESH_BPD = 256
CACHE_BUDGET = 8 * MESH_KEYS


def _mesh_cases(shape):
    cases = [dict(name=v, variant=v, slack=2.0, cache=0)
             for v in ("outback", "race")]
    if shape == (2, 4):
        cases += [dict(name=f"{v}+cache", variant=v, slack=2.0,
                       cache=CACHE_BUDGET) for v in ("outback", "race")]
        cases += [dict(name=f"{v}+skew", variant=v, slack=1.0, cache=0)
                  for v in ("outback", "race")]
    return cases


def _mesh_batch(keys, case, shape, seed):
    """The global batch: zipf Gets with sentinel and absent lanes; a skewed
    case sends 60% of its lanes to shard 0's keys."""
    rng = np.random.default_rng(seed)
    B = MESH_BPD * shape[0] * shape[1]
    q = _queries(keys, B, seed)
    if case["name"].endswith("+skew"):
        lo, hi = split_u64(keys)
        own = keys[hash64_32_np(lo, hi, T._ROUTE_SEED) % np.uint32(shape[1])
                   == 0]
        hot = rng.random(B) < 0.6
        q[hot] = own[rng.integers(0, own.size, int(hot.sum()))]
    if case["cache"]:
        q = keys[rng.zipf(1.4, B) % keys.size]
        q[::97] = ALL_ONES
    return q


REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core import sharded_kvs as skv
    from repro.core.cn_cache import CNKeyCache, ShardedCNCache
    from repro.core.hashing import split_u64
    from _torch_mesh_rank import warm_cache
    for path in sys.argv[1:]:
        data = np.load(path)
        D, M = (int(x) for x in data["shape"])
        mesh = jax.make_mesh((D, M), ("data", "model"),
                             devices=jax.devices()[:D * M])
        st = skv.build_sharded(data["keys"], data["vals"], num_shards=M,
                               data_parallel=D)
        arrays = skv.place_state(mesh, st)
        qs = NamedSharding(mesh, P(("data", "model")))
        out = {}
        for case in json.loads(str(data["cases"])):
            name = case["name"]
            q = data["q_" + name]
            extra, cache = (), None
            if case["cache"]:
                host = warm_cache(CNKeyCache(case["cache"]),
                                  data["w_" + name], data["wv_" + name])
                cache = ShardedCNCache(host, D * M)
                extra = skv.place_cache(mesh, cache)
            fn, caps = skv.make_get_fn(mesh, st, q.size // (D * M),
                                       capacity_slack=case["slack"],
                                       variant=case["variant"], cache=cache)
            lo, hi = split_u64(q)
            res = fn(jax.device_put(jnp.asarray(lo), qs),
                     jax.device_put(jnp.asarray(hi), qs), *extra, *arrays)
            for field, x in zip(("v_lo", "v_hi", "match", "hit"), res):
                out[name + "/" + field] = np.asarray(x)
            out[name + "/caps"] = np.asarray(caps)
        np.savez(path.replace("cases_", "ref_"), **out)
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Each mesh shape's cases run once: the reference in one subprocess
    over 8 host devices, the port in one world of spawned gloo ranks a
    shape (one after another), both at once.  Returns ``{shape: (ref,
    ranks)}`` of loaded ``.npz`` outputs."""
    root = tmp_path_factory.mktemp("mesh")
    keys = make_uniform_keys(MESH_KEYS, 21)
    vals = splitmix64(keys)
    files = {}
    for shape in MESHES:
        cases = _mesh_cases(shape)
        arrays = dict(keys=keys, vals=vals, shape=np.asarray(shape),
                      cases=np.asarray(json.dumps(cases)))
        for i, case in enumerate(cases):
            arrays["q_" + case["name"]] = _mesh_batch(keys, case, shape, i)
            if case["cache"]:
                warm = keys[np.random.default_rng(i).zipf(1.4, 4096)
                            % keys.size]
                arrays["w_" + case["name"]] = warm
                arrays["wv_" + case["name"]] = splitmix64(warm)
        files[shape] = root / f"cases_{shape[0]}x{shape[1]}.npz"
        np.savez(files[shape], **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                            *map(str, files.values())], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        for shape, path in files.items():
            world_size = shape[0] * shape[1]
            rdv = root / f"rdv_{shape[0]}x{shape[1]}"
            procs = [subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_mesh_rank.py"),
                 str(path), str(rdv), str(r),
                 str(root / f"rank_{shape[0]}x{shape[1]}_{r}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for r in range(world_size)]
            for p in procs:
                _, err = p.communicate(timeout=180)
                assert p.returncode == 0, err[-3000:]
        out, err = ref.communicate(timeout=300)
        assert "REF_OK" in out, err[-3000:]
    finally:
        ref.kill()
    runs = {}
    for shape in MESHES:
        tag = f"{shape[0]}x{shape[1]}"
        runs[shape] = (dict(np.load(root / f"ref_{tag}.npz")),
                       [dict(np.load(root / f"rank_{tag}_{r}.npz"))
                        for r in range(shape[0] * shape[1])])
    return runs


MESH_CASES = [(shape, case["name"]) for shape in MESHES
              for case in _mesh_cases(shape)]


@pytest.mark.mesh
@pytest.mark.parametrize("shape,name", MESH_CASES,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n in MESH_CASES])
def test_spawned_mesh_matches_reference(mesh_runs, shape, name):
    ref, ranks = mesh_runs[shape]
    fields = ("v_lo", "v_hi", "match") + (("hit",) if "cache" in name
                                         else ())
    for f in fields:
        got = np.concatenate([r[f"{name}/{f}"] for r in ranks])
        want = ref[f"{name}/{f}"]
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}/caps"], ref[f"{name}/caps"])
    match = ref[f"{name}/match"]
    sent = (ref[f"{name}/v_lo"] == 0xFFFFFFFF) & \
        (ref[f"{name}/v_hi"] == 0xFFFFFFFF) & ~match
    if name.endswith("+skew"):
        assert sent.sum() > 0  # full bins dropped lanes, compared above
    if "cache" in name:
        assert ref[f"{name}/hit"].sum() > 0
    assert match.mean() > (0.3 if name.endswith("+skew") else 0.9)
