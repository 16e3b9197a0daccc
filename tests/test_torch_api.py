"""Port vs reference through the public entry point: ``open_store``.

``repro_torch.api.open_store(StoreSpec("outback", ...), device="cpu")`` is
held against ``repro.api.open_store`` on YCSB A-D mixes (made from seeds
with numpy) at ``BatchPolicy(window=1 | 64 | 1024)``: every handle's
``OpResult`` — values, found, statuses and the meter stage's attribution —
the pipeline's own counters and the final ``CommMeter.snapshot()`` must be
identical.  A spec's JSON is the same in both packages, and each option
this slice has not ported raises ``SpecError``.
"""

import dataclasses

import numpy as np
import pytest

from repro import api as r_api
from repro.core.hashing import splitmix64
from repro.core.store import make_uniform_keys
from repro_torch import api as t_api
from repro_torch.kernels import ops

N = 4096
N_OPS = 600
ATTRIBUTION = ("round_trips", "req_bytes", "resp_bytes", "makeups",
               "cache_hits", "cache_neg_hits", "retries", "backoffs",
               "failovers")


@pytest.fixture(scope="module")
def data():
    keys = make_uniform_keys(N, 5)
    return keys, splitmix64(keys)


def _zipf_ranks(rng, n_items, size, theta=0.99):
    p = 1.0 / np.arange(1, n_items + 1) ** theta
    return rng.choice(n_items, size=size, p=p / p.sum())


def _ycsb(mix, keys, n_ops, seed):
    """A YCSB core-workload stream: ``(op, key, value)`` triples.

    A: 50% read / 50% update, zipfian; B: 95 / 5; C: read only;
    D: 95% read of the latest keys / 5% insert of new ones."""
    rng = np.random.default_rng(seed)
    fresh = splitmix64(np.arange(1, n_ops + 1, dtype=np.uint64)
                       + np.uint64(seed << 40))
    # a fixed key permutation makes the zipf head land on scattered keys
    order = keys[rng.permutation(keys.size)]
    write_p = {"A": 0.5, "B": 0.05, "C": 0.0, "D": 0.05}[mix]
    ranks = _zipf_ranks(rng, keys.size, n_ops)
    writes = rng.random(n_ops) < write_p
    vals = rng.integers(0, 1 << 63, n_ops, dtype=np.uint64)
    inserted = []
    out = []
    for t in range(n_ops):
        if mix == "D":
            if writes[t]:
                inserted.append(int(fresh[t]))
                out.append(("insert", int(fresh[t]), int(vals[t])))
            else:  # "latest": zipf over recency, newest first
                pool = inserted[::-1] + order.tolist()
                out.append(("get", int(pool[ranks[t] % len(pool)]), None))
        elif writes[t]:
            out.append(("update", int(order[ranks[t]]), int(vals[t])))
        else:
            out.append(("get", int(order[ranks[t]]), None))
    return out


def _drive(store, stream):
    handles = []
    for op, k, v in stream:
        handles.append(store.submit(op, k) if v is None
                       else store.submit(op, k, v))
    store.flush()
    return handles


def _result_tuple(res):
    return (res.values.tolist(), res.found.tolist(), res.statuses,
            tuple(getattr(res, f) for f in ATTRIBUTION))


@pytest.mark.parametrize("window", [1, 64, 1024])
@pytest.mark.parametrize("mix", ["A", "B", "C", "D"])
def test_ycsb_through_open_store_matches_reference(data, mix, window):
    keys, vals = data
    policy = dict(window=window)
    r = r_api.open_store(r_api.StoreSpec("outback", load_factor=0.85,
                                         batch=r_api.BatchPolicy(**policy)),
                         keys, vals)
    t = t_api.open_store(t_api.StoreSpec("outback", load_factor=0.85,
                                         batch=t_api.BatchPolicy(**policy)),
                         keys, vals, device="cpu")
    stream = _ycsb(mix, keys, N_OPS, seed=ord(mix))
    rh, th = _drive(r, stream), _drive(t, stream)
    for a, b in zip(rh, th):
        assert _result_tuple(a.result()) == _result_tuple(b.result())
        assert _result_tuple(a.batch) == _result_tuple(b.batch)
    assert dataclasses.asdict(r.stats) == dataclasses.asdict(t.stats)
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    # the sync conveniences and the scalar walks, after the stream
    probe = np.concatenate([keys[:300], np.asarray([k for _, k, _ in stream],
                                                   np.uint64)])
    assert _result_tuple(r.get_batch(probe)) == \
        _result_tuple(t.get_batch(probe))
    for k in probe[::37]:
        assert _result_tuple(r.get(int(k))) == _result_tuple(t.get(int(k)))
        assert _result_tuple(r.delete(int(k))) == \
            _result_tuple(t.delete(int(k)))
        assert _result_tuple(r.insert(int(k), 9)) == \
            _result_tuple(t.insert(int(k), 9))
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    assert ops.LAUNCHES == {"ludo_lookup": 0, "slot_unpack": 0}


@pytest.mark.parametrize("policy", [dict(window=256, order="relaxed"),
                                    dict(window=128, combine_reads=True)])
def test_pipeline_policies_match_reference(data, policy):
    keys, vals = data
    r = r_api.open_store(r_api.StoreSpec("outback", load_factor=0.85,
                                         batch=r_api.BatchPolicy(**policy)),
                         keys, vals)
    t = t_api.open_store(t_api.StoreSpec("outback", load_factor=0.85,
                                         batch=t_api.BatchPolicy(**policy)),
                         keys, vals, device="cpu")
    stream = _ycsb("A", keys, N_OPS, seed=3) + [
        ("delete", int(k), None) for k in keys[:40]] + [
        ("get", int(k), None) for k in keys[:60]]
    for a, b in zip(_drive(r, stream), _drive(t, stream)):
        assert _result_tuple(a.result()) == _result_tuple(b.result())
    assert dataclasses.asdict(r.stats) == dataclasses.asdict(t.stats)
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()


def test_batched_mutations_through_open_store_match(data):
    keys, vals = data
    r = r_api.open_store(r_api.StoreSpec("outback", load_factor=0.85),
                         keys, vals)
    t = t_api.open_store(t_api.StoreSpec("outback", load_factor=0.85),
                         keys, vals, device="cpu")
    fresh = splitmix64(np.arange(1, 400, dtype=np.uint64) + np.uint64(3 << 41))
    for call in (lambda s: s.insert_batch(fresh, fresh),
                 lambda s: s.update_batch(keys[:500], keys[:500]),
                 lambda s: s.delete_batch(np.concatenate([keys[:50], fresh])),
                 lambda s: s.get_batch(keys, resolve_makeup=False),
                 lambda s: s.get_batch(np.concatenate([keys, fresh]))):
        assert _result_tuple(call(r)) == _result_tuple(call(t))
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    r.reset_meters()
    t.reset_meters()
    assert t.meter_totals().snapshot() == r.meter_totals().snapshot()


# ------------------------------------------------------------ spec / json
SPECS = [
    dict(kind="outback"),
    dict(kind="outback", load_factor=0.95, rng_seed=7),
    dict(kind="outback", params={"overflow_frac": 0.05, "heap_slack": 1.5}),
    dict(kind="outback", replicas=2, placement_k=2),
    dict(kind="race", cache_budget_bytes=1 << 16),
]


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("batch", [None, dict(window=64, order="relaxed")])
def test_spec_json_is_identical_in_both_packages(kw, batch):
    r = r_api.StoreSpec(**kw, batch=None if batch is None
                        else r_api.BatchPolicy(**batch))
    t = t_api.StoreSpec(**kw, batch=None if batch is None
                        else t_api.BatchPolicy(**batch))
    assert r.to_json() == t.to_json()
    assert t_api.StoreSpec.from_json(r.to_json()) == t
    assert r_api.StoreSpec.from_json(t.to_json()) == r


@pytest.mark.parametrize("kw,what", [
    (dict(kind="outback", cache_budget_bytes=1 << 16), "cache_budget_bytes"),
    (dict(kind="outback", replicas=2), "replicas"),
    (dict(kind="outback", faults={"events": []}), "faults"),
    (dict(kind="outback", telemetry={"sample": 1.0}), "telemetry"),
    (dict(kind="outback-dir"), "outback-dir"),
    (dict(kind="race"), "race"),
    (dict(kind="sharded"), "sharded"),
])
def test_unported_options_raise_spec_error(data, kw, what):
    keys, vals = data
    with pytest.raises(t_api.SpecError, match="not yet ported") as e:
        t_api.open_store(t_api.StoreSpec(**kw), keys, vals, device="cpu")
    assert what in str(e.value)


def test_spec_errors_match_reference_validation(data):
    keys, vals = data
    with pytest.raises(t_api.SpecError, match="transport"):
        t_api.open_store(t_api.StoreSpec("outback"), keys, vals,
                         device="cpu", transport=object())
    for bad in (dict(kind="nope"), dict(kind="outback", load_factor=1.5),
                dict(kind="outback", params={"bogus": 1}),
                dict(kind="outback", batch={"window": -3})):
        with pytest.raises(r_api.SpecError):
            r_api.StoreSpec(**bad).validate()
        with pytest.raises(t_api.SpecError):
            t_api.StoreSpec(**bad).validate()
    with pytest.raises(t_api.SpecError, match="shape mismatch"):
        t_api.open_store(t_api.StoreSpec("outback"), keys, vals[:-1],
                         device="cpu")


def test_store_satisfies_the_protocols(data):
    keys, vals = data
    t = t_api.open_store(t_api.StoreSpec("outback"), keys, vals, device="cpu")
    assert isinstance(t, t_api.PipelinedKVStore)
    assert isinstance(t, t_api.KVStore)
    assert isinstance(t.inner, t_api.MeterLayer)
    assert isinstance(t.inner.inner, t_api.OutbackShardAdapter)
    assert t.spec == t_api.StoreSpec("outback") and t.telemetry is None
    assert t.engine.device.type == "cpu"
    assert t_api.registered_kinds() == ("outback",)
    assert t_api.registry_docs() == {
        "outback": r_api.registry_docs()["outback"]}
