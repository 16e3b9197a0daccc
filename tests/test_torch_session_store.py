"""Session parking through the KVS: the port's ``KVSessionStore`` and
``Engine(session_store=...)`` against ``repro``'s.

Mirrors ``test_api_pipeline.py::test_session_store_coalesces_parks``,
``test_net_sim.py::test_session_store_rides_the_clock``,
``test_cn_cache.py::test_session_store_roundtrip_reads_through_cache`` and
both park/resume tests of ``test_train_serve.py`` (on the reduced rwkv6
and llama3.2-1b), each through both packages on the CPU: answers,
``meter_total().snapshot()``, traces (as tuples), the CN cache's whole
state and ``state_signature`` of the store's MN images must be equal.
Three more: a lane parked from the same state in both packages gives the
same blob, byte for byte, and so the same chunk values and MN images
(float32 and bf16); a blob of ``_MAX_CHUNKS`` words or more is refused,
as is a full-width rwkv6-1.6b lane; a blob lost from the store raises
``KeyError`` on resume and keeps the parked entry, so a retry succeeds.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cache_state import assert_same_cache
from repro.configs import get_config as r_get_config
from repro.models.lm import LM as RLM
from repro.net import Transport as RTransport
from repro.net import simulate as r_simulate
from repro.net.chaos import state_signature as r_sig
from repro.serve import Engine as REngine
from repro.serve import KVSessionStore as RKVSessionStore
from repro.serve import Request as RRequest
from repro_torch.configs import get_config
from repro_torch.models.common import sorted_leaves, tree_map
from repro_torch.models.lm import LM, params_from_reference
from repro_torch.net import Transport, simulate
from repro_torch.net.chaos import state_signature as t_sig
from repro_torch.serve import Engine, KVSessionStore, Request
from repro_torch.serve.session_store import _MAX_CHUNKS

REF = types.SimpleNamespace(Store=RKVSessionStore, Transport=RTransport,
                            simulate=r_simulate, sig=r_sig, Engine=REngine,
                            Request=RRequest, kw={})
PORT = types.SimpleNamespace(Store=KVSessionStore, Transport=Transport,
                             simulate=simulate, sig=t_sig, Engine=Engine,
                             Request=Request, kw={"device": "cpu"})


def _trace(trace):
    return [(type(x).__name__, dataclasses.astuple(x)) for x in trace]


def _artifacts(P, ss, tr=None):
    return {"meter": ss.meter_total().snapshot(),
            "trace": None if tr is None else _trace(tr.trace),
            "state": P.sig(ss.store.engine.mn_state()),
            "cache": dataclasses.asdict(ss.cache_stats)}


def _same_stores(t, r, t_tr=None, r_tr=None) -> None:
    assert _artifacts(PORT, t, t_tr) == _artifacts(REF, r, r_tr)
    assert_same_cache(r.store.cache, t.store.cache)


# ----------------------------------------------------------- the store
def test_session_store_coalesces_parks():
    def run(P):
        tr = P.Transport()
        ss = P.Store(cn_cache_budget_bytes=32 << 10, batch_window=512,
                     transport=tr, **P.kw)
        blobs = {rid: bytes([rid % 256]) * (64 + rid) for rid in range(8)}
        for rid, blob in blobs.items():
            ss.put(rid, blob)
        pending = ss.store._n_pending
        out = [pending, ss.get(3) == blobs[3], ss.store._n_pending]
        out += [ss.get(rid) == blob for rid, blob in blobs.items()]
        ss.put(3, b"xy")
        out += [ss.get(3), ss.delete(3), ss.get(3)]
        m = ss.meter_total()
        out += [m.round_trips > 0, ss.store._n_pending]
        return ss, tr, out

    t, t_tr, t_out = run(PORT)
    r, r_tr, r_out = run(REF)
    assert t_out == r_out
    _same_stores(t, r, t_tr, r_tr)
    assert t_out[0] > 0 and t_out[1] and t_out[2] == 0
    assert all(t_out[3:11])
    assert t_out[11:14] == [b"xy", True, None]
    assert t_out[14] and t_out[15] == 0


def test_session_store_rides_the_clock():
    def run(P):
        tr = P.Transport()
        ss = P.Store(cn_cache_budget_bytes=32 << 10, bootstrap_keys=1024,
                     transport=tr, **P.kw)
        blob = bytes(range(256)) * 8
        ss.put(1, blob)
        out = [len(tr), ss.store._n_pending > 0]
        ss.flush()
        out.append(len(tr))
        out.append(ss.get(1) == blob)
        out.append(len(tr))
        res = P.simulate(tr.trace, clients=4)
        res_pol = P.simulate(tr.trace, clients=1, window="policy")
        res_sync = P.simulate(tr.trace, clients=1, window=1)
        out += [(r.n_ops, r.seconds, r.percentile_us(50))
                for r in (res, res_pol, res_sync)]
        return ss, tr, out

    t, t_tr, t_out = run(PORT)
    r, r_tr, r_out = run(REF)
    assert t_out == r_out
    _same_stores(t, r, t_tr, r_tr)
    n0, pending, n_put, ok, n_get, res, pol, sync = t_out
    assert n0 == 0 and pending
    assert n_put > 0 and ok and n_get > n_put
    assert res[0] == n_get and res[2] > 0
    assert pol[0] == sync[0] and pol[1] < sync[1]


def test_session_store_roundtrip_reads_through_cache():
    blob = np.random.default_rng(0).bytes(4093)

    def run(P):
        ss = P.Store(cn_cache_budget_bytes=64 << 10, **P.kw)
        ss.put(7, blob)
        out = [ss.get(7) == blob]
        h0 = ss.cache_stats.hits
        out += [ss.get(7) == blob, ss.cache_stats.hits > h0, ss.get(999),
                ss.delete(7), ss.delete(7), ss.get(7)]
        return ss, out

    t, t_out = run(PORT)
    r, r_out = run(REF)
    assert t_out == r_out == [True, True, True, None, True, False, None]
    _same_stores(t, r)


def test_oversize_blob_is_refused():
    """``put`` refuses ``_MAX_CHUNKS`` words, as the reference does; a
    full-width rwkv6-1.6b lane (24 layers of a 2048-wide bf16 token shift,
    a 32x64x64 float32 state and a 2048-wide bf16 channel-mix shift, plus
    the 4-byte length) is 12,779,524 B, 1,597,441 words, and is refused."""
    tmpl = LM(get_config("rwkv6-1.6b"), device="cpu").cache_template(1, 8)
    sizes = {"float32": 4, "bfloat16": 2, "int32": 4}
    lane = sum(int(np.prod(lf.shape)) // (lf.shape[0] if len(lf.shape) == 1
                                          else lf.shape[1])
               * sizes[lf.dtype] for _, lf in sorted_leaves(tmpl))
    assert lane == 24 * (2048 * 2 + 32 * 64 * 64 * 4 + 2048 * 2) + 4 \
        == 12_779_524
    for P in (PORT, REF):
        ss = P.Store(bootstrap_keys=256, **P.kw)
        for n in (lane, 8 * _MAX_CHUNKS, 8 * _MAX_CHUNKS - 7):
            with pytest.raises(ValueError, match="session blob too large"):
                ss.put(1, bytes(n))
        assert ss.store._n_pending == 0 and ss.get(1) is None


# ---------------------------------------------------------- the engine
def _models(arch: str, dtype: str = "float32"):
    rc = dataclasses.replace(r_get_config(arch, reduced=True), dtype=dtype)
    tc = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    rm = RLM(rc)
    rp = rm.init(0)
    tm = LM(tc, device="cpu")
    tp = params_from_reference(
        jax.device_get(rp), device="cpu",
        dtype=torch.float32 if dtype == "float32" else None)
    return (rm, rp), (tm, tp)


@pytest.fixture(scope="module", params=["rwkv6-1.6b", "llama3.2-1b"])
def models(request):
    return request.param, _models(request.param)


def _lane(eng, lane):
    return tree_map(lambda c: (c[:, lane] if c.dim() >= 2 else c[lane]
                               ).clone(), eng.cache)


def _assert_equal_trees(a, b) -> None:
    la, lb = sorted_leaves(a), sorted_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_engine_park_resume_preserves_state(models):
    """In process (no store): the length and the whole lane come back."""
    arch, ((rm, rp), (tm, tp)) = models
    lengths = []
    for P, m, p in ((PORT, tm, tp), (REF, rm, rp)):
        eng = P.Engine(m, p, lanes=2, max_seq=64)
        eng.submit(P.Request(rid=1, prompt=[4, 5, 6], max_new=30))
        for _ in range(3):
            eng.step()
        before = int(np.asarray(eng.cache["length"])[0])
        if P is PORT:
            state = _lane(eng, 0)
        rid = eng.park(0)
        lane = eng.resume(rid)
        after = int(np.asarray(eng.cache["length"])[lane])
        assert after == before
        if P is PORT:
            _assert_equal_trees(_lane(eng, lane), state)
        lengths.append(after)
    assert lengths[0] == lengths[1]


def test_engine_park_resume_via_kvs_session_store(models):
    """The lane's state travels through the Outback KVS and comes back
    bit for bit; the second resume reads through the CN cache; a finished
    session's blob is reclaimed.  Both packages make the same number of
    parks and resumes, inserts, round trips and cache hits."""
    arch, ((rm, rp), (tm, tp)) = models
    runs = {}
    for P, m, p in ((PORT, tm, tp), (REF, rm, rp)):
        ss = P.Store(cn_cache_budget_bytes=256 << 10, **P.kw)
        eng = P.Engine(m, p, lanes=2, max_seq=64, session_store=ss)
        req = P.Request(rid=1, prompt=[4, 5, 6], max_new=30)
        eng.submit(req)
        for _ in range(3):
            eng.step()
        before = int(np.asarray(eng.cache["length"])[0])
        if P is PORT:
            state = _lane(eng, 0)
        rid = eng.park(0)
        lane = eng.resume(rid)
        assert int(np.asarray(eng.cache["length"])[lane]) == before
        if P is PORT:
            _assert_equal_trees(_lane(eng, lane), state)
            state = _lane(eng, lane)
        rid = eng.park(lane)
        h0 = ss.cache_stats.hits
        lane = eng.resume(rid)
        assert ss.cache_stats.hits > h0
        if P is PORT:
            _assert_equal_trees(_lane(eng, lane), state)
        eng.run()
        assert req.done and ss.get(rid) is None  # reclaimed on finish
        runs[P is PORT] = (ss.meter_total().snapshot(),
                           dataclasses.asdict(ss.cache_stats),
                           dataclasses.asdict(eng.stats))
    assert runs[True] == runs[False]


def _seeded_cache(P, eng, seed: int):
    """Write the same seeded values into every leaf of ``eng``'s cache,
    leaf by leaf in the reference's order (lengths in [0, 16))."""
    rng = np.random.default_rng(seed)
    if P is REF:
        leaves, treedef = jax.tree.flatten(eng.cache)
        new = []
        for x in leaves:
            if x.dtype == jnp.int32:
                a = rng.integers(0, 16, x.shape).astype(np.int32)
            else:
                a = (rng.standard_normal(x.shape) * 3).astype(np.float32)
            new.append(jnp.asarray(a, x.dtype))
        eng.cache = jax.tree.unflatten(treedef, new)
        return
    for _, t in sorted_leaves(eng.cache):
        if t.dtype == torch.int32:
            a = torch.from_numpy(rng.integers(0, 16, tuple(t.shape))
                                 .astype(np.int32))
        else:
            a = torch.from_numpy((rng.standard_normal(tuple(t.shape)) * 3)
                                 .astype(np.float32))
        t.copy_(a.to(t.dtype))


@pytest.mark.parametrize("arch,dtype", [("rwkv6-1.6b", "float32"),
                                        ("rwkv6-1.6b", "bfloat16"),
                                        ("llama3.2-1b", "float32")])
def test_park_blob_bytes_equal_reference(arch, dtype):
    """From the same lane state both packages park the same bytes (the
    order of ``jax.tree.flatten``: length, then each layer's ffn shift,
    mixer state, mixer shift), with the same shapes and byte counts in the
    parked entry, and so the same chunk values, meters and MN images."""
    (rm, rp), (tm, tp) = _models(arch, dtype)
    out = {}
    for P, m, p in ((PORT, tm, tp), (REF, rm, rp)):
        ss = P.Store(cn_cache_budget_bytes=32 << 10, **P.kw)
        blobs = []
        put = ss.put
        ss.put = lambda rid, blob: (blobs.append(blob), put(rid, blob))[1]
        eng = P.Engine(m, p, lanes=3, max_seq=16, session_store=ss)
        _seeded_cache(P, eng, seed=5)
        eng.active[1] = P.Request(rid=7, prompt=[1])
        eng.park(1)
        meta = [(tuple(s), n) for s, _, n in eng.parked_states[7]["meta"]]
        ss.flush()
        out[P is PORT] = (blobs, meta, _artifacts(P, ss))
    assert out[True][0][0] == out[False][0][0]
    assert out[True] == out[False]


def test_lost_blob_keeps_the_parked_entry():
    """A blob that vanished from the store raises ``KeyError`` on resume
    and keeps the entry (the reference's handling); once the blob is back,
    the same resume succeeds with the parked state."""
    (rm, rp), (tm, tp) = _models("rwkv6-1.6b")
    for P, m, p in ((PORT, tm, tp), (REF, rm, rp)):
        ss = P.Store(cn_cache_budget_bytes=32 << 10, **P.kw)
        blobs = []
        put = ss.put
        ss.put = lambda rid, blob: (blobs.append(blob), put(rid, blob))[1]
        eng = P.Engine(m, p, lanes=2, max_seq=64, session_store=ss)
        eng.submit(P.Request(rid=3, prompt=[4, 5, 6], max_new=30))
        for _ in range(2):
            eng.step()
        if P is PORT:
            state = _lane(eng, 0)
        rid = eng.park(0)
        assert ss.delete(rid) and ss.get(rid) is None
        with pytest.raises(KeyError, match="lost from the KVS"):
            eng.resume(rid)
        assert rid in eng.parked_states
        assert eng.stats.resumed == 0
        put(rid, blobs[0])  # the blob comes back: the retry succeeds
        lane = eng.resume(rid)
        assert rid not in eng.parked_states and eng.stats.resumed == 1
        if P is PORT:
            _assert_equal_trees(_lane(eng, lane), state)
