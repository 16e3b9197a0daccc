"""Port vs reference: the continuous-batching ``Engine`` over the dense LM.

Both packages serve the same requests from the same weights (the
reference's ``init``, carried across in float32 by
``params_from_reference``) at the reduced llama3.2-1b in float32, on the
CPU.  Every request must get the same tokens and ``EngineStats`` must be
equal; the final caches agree to 1e-5 (rtol and atol: both sides compute
in float32 from identical values and differ only in the order of their
sums) and their lengths exactly.  The cases are ``examples/serve_kvs.py``
part 1, ``tests/test_train_serve.py::test_engine_serves_all``, and a short
``max_seq`` at which requests finish by length while idle lanes run past
the cache.  An engine with a ``KVSessionStore`` parks through the KVS as
the reference's does.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models.lm import LM as RLM
from repro.serve import Engine as REngine
from repro.serve import Request as RRequest
from repro_torch.configs import get_config
from repro_torch.models.lm import LM, params_from_reference
from repro_torch.serve import Engine, Request


@pytest.fixture(scope="module")
def models():
    rcfg = dataclasses.replace(r_get_config("llama3.2-1b", reduced=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True),
                               dtype="float32")
    rm = RLM(rcfg)
    rp = rm.init(0)
    tm = LM(tcfg, device="cpu")
    tp = params_from_reference(jax.device_get(rp), device="cpu",
                               dtype=torch.float32)
    return rm, rp, tm, tp


def _example_part1(vocab):
    rng = np.random.default_rng(0)
    return [(i, [int(t) for t in rng.integers(1, vocab, 5)], 8)
            for i in range(10)]


CASES = {  # name -> (lanes, max_seq, requests of (rid, prompt, max_new))
    "serve_kvs_part1": (4, 96, _example_part1(512)),
    "serves_all": (2, 48, [(i, [1, 2, 3], 4) for i in range(4)]),
    "max_seq_finish": (3, 12, [(i, list(range(1 + i, 10 + 2 * i)), 20)
                               for i in range(4)]),
}


def _serve(engine_cls, request_cls, model, params, lanes, max_seq, reqs):
    eng = engine_cls(model, params, lanes=lanes, max_seq=max_seq)
    rs = [request_cls(rid=rid, prompt=list(p), max_new=n) for rid, p, n in reqs]
    for r in rs:
        eng.submit(r)
    eng.run()
    return eng, {r.rid: (list(map(int, r.out)), r.done) for r in rs}


def _check_caches(teng, reng):
    tc, rc = teng.cache, reng.cache
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(rc["length"]))
    mixer = rc["stages"][0][0]["mixer"]
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["stages"][0][0]["mixer"][k].numpy(),
                                   np.asarray(mixer[k]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_generates_what_the_reference_does(models, case):
    rm, rp, tm, tp = models
    lanes, max_seq, reqs = CASES[case]
    reng, rout = _serve(REngine, RRequest, rm, rp, lanes, max_seq, reqs)
    teng, tout = _serve(Engine, Request, tm, tp, lanes, max_seq, reqs)
    assert tout == rout
    assert all(done for _, done in tout.values())
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(reng.stats)
    assert teng.stats.finished == len(reqs)
    assert teng.stats.prefill_tokens == sum(len(p) for _, p, _ in reqs)
    _check_caches(teng, reng)


def test_park_resume_like_the_reference(models):
    """A lane parked mid-request and resumed (in the in-process dict) gets
    the reference's state back and finishes with the reference's tokens."""
    rm, rp, tm, tp = models
    runs = []
    for eng_cls, req_cls, model, params in ((REngine, RRequest, rm, rp),
                                            (Engine, Request, tm, tp)):
        eng = eng_cls(model, params, lanes=2, max_seq=64)
        reqs = [req_cls(rid=1, prompt=[4, 5, 6], max_new=12),
                req_cls(rid=2, prompt=[7, 8], max_new=6)]
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        before = int(np.asarray(eng.cache["length"])[0])
        rid = eng.park(0)
        assert rid == 1 and eng.active[0] is None
        for _ in range(2):
            eng.step()  # request 2 goes on alone
        lane = eng.resume(rid)
        assert int(np.asarray(eng.cache["length"])[lane]) == before
        eng.run()
        runs.append((eng, [list(map(int, r.out)) for r in reqs]))
    (reng, rtoks), (teng, ttoks) = runs
    assert ttoks == rtoks
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(reng.stats)
    assert teng.stats.parked == teng.stats.resumed == 1
    _check_caches(teng, reng)


def test_session_store_is_not_yet_ported(models):
    """``session_store=`` is taken: with a ``KVSessionStore`` (on the CPU)
    the engine parks a lane mid-request through the KVS, resumes it, and
    serves every request with the reference's tokens and ``EngineStats``
    (the reference engine over the reference's store)."""
    from repro.serve import KVSessionStore as RKVSessionStore
    from repro_torch.serve import KVSessionStore
    rm, rp, tm, tp = models
    runs = []
    for eng_cls, req_cls, model, params, ss in (
            (REngine, RRequest, rm, rp, RKVSessionStore()),
            (Engine, Request, tm, tp, KVSessionStore(device="cpu"))):
        eng = eng_cls(model, params, lanes=2, max_seq=48, session_store=ss)
        reqs = [req_cls(rid=i, prompt=[1, 2, 3], max_new=4) for i in range(4)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        eng.resume(eng.park(1))
        eng.run()
        assert ss.get(1) is None  # the finished session's blob reclaimed
        runs.append((eng, [list(map(int, r.out)) for r in reqs],
                     ss.meter_total().snapshot()))
    (reng, rtoks, rmeter), (teng, ttoks, tmeter) = runs
    assert ttoks == rtoks and tmeter == rmeter
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(reng.stats)
    assert teng.stats.finished == 4 and teng.stats.parked == 1
