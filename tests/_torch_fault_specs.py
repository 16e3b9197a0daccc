"""The failure plane's parity cases: specs, one seeded op stream, a runner.

Shared by ``tests/test_torch_faults.py`` (the port against ``repro`` on the
CPU) and ``tests/test_torch_cuda.py`` (the port on the card against the
port on the CPU).  Imports only numpy and ``repro_torch``: every spec is a
port ``StoreSpec``, and the reference opens the same store from its JSON.

Each spec drives a different part of the plane through ``open_store``:

* ``k2_crash`` — K=2, the primary crashes (leases at 128): backoff,
  retry, failover, resync;
* ``k1_crash`` — K=1 under the same crash: retries until the window ends;
* ``generated`` — ``FaultSchedule.generate``: a crash, a delay and a drop
  window at K=2;
* ``partition`` — the link between CN 0 and MN 1 is cut: writes skip MN 1,
  which resyncs when the link heals;
* ``cn_delay`` / ``cn_drop`` — windows scoped to the calling CN;
* ``k2_cache`` — K=2 with a CN cache and no retries: degraded
  ``"unavailable"`` answers reach the cache stage, which must not learn
  from them;
* ``dir_twins`` — ``outback-dir`` at K=2: the crashed replica sleeps
  through a §4.4 split and is rebuilt from the donor's image (leases on);
* ``dir_late`` — ``outback-dir`` at K=2 whose primary crashes after the
  splits and never fails over (``failover_after`` past ``max_retries``):
  its reads back off, then degrade, and after the in-place resync its CN
  seeds are stale, so Makeup-Gets on split successors renew leases;
* ``dir_hrw`` — ``outback-dir`` with ``replicas=3``, ``placement="hrw"``,
  ``placement_k=2`` and a crash of MN 1, then inserts that split tables;
* ``dir_hrw_diverged`` — the same with the crash over the splits: the
  per-shard resync refuses the diverged table numbering, in both packages
  at the same call with the same message.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api import BatchPolicy, ReplicaSetAdapter, StoreSpec
from repro_torch.net import FaultEvent, FaultSchedule

N = 2048
ATTRIBUTION = ("round_trips", "req_bytes", "resp_bytes", "makeups",
               "cache_hits", "cache_neg_hits", "retries", "backoffs",
               "failovers")


def fault_data(n: int = N):
    """Build keys and values, then as many fresh keys to write."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(1, 1 << 62, 2 * n + 512, dtype=np.uint64))
    assert len(keys) >= 2 * n
    vals = np.arange(len(keys), dtype=np.uint64)
    return keys[:n], vals[:n], keys[n:2 * n], vals[n:2 * n]


def _crash(**kw):
    return FaultSchedule.single_crash(at_op=64, duration_ops=256,
                                      lease_term_ops=128, **kw)


def _dir_crash(at_op: int, duration_ops: int, mn: int):
    return FaultSchedule.single_crash(at_op=at_op, duration_ops=duration_ops,
                                      mn=mn, lease_term_ops=128)


# name -> (spec, stream shape); "shard" streams write few keys (one table's
# overflow cache bounds them), "dir" streams write enough to split tables
SPECS = {
    "k2_crash": (StoreSpec("outback", load_factor=0.85, replicas=2,
                           faults=_crash()), "shard"),
    "k1_crash": (StoreSpec("outback", load_factor=0.85, faults=_crash()),
                 "shard"),
    "generated": (StoreSpec("outback", load_factor=0.85, replicas=2,
                            faults=FaultSchedule.generate(11, 1500,
                                                          replicas=2)),
                  "shard"),
    "partition": (StoreSpec("outback", load_factor=0.85, replicas=2,
                            faults=FaultSchedule(
                                events=(FaultEvent("partition", 96, 256,
                                                   mn=1, cn=0,
                                                   down_s=150e-6),),
                                lease_term_ops=128)), "shard"),
    "cn_delay": (StoreSpec("outback", load_factor=0.85, replicas=2,
                           faults=FaultSchedule(
                               events=(FaultEvent("cn_delay", 32, 256, cn=0,
                                                  extra_us=3.5),),
                               lease_term_ops=128)), "shard"),
    "cn_drop": (StoreSpec("outback", load_factor=0.85, replicas=2,
                          faults=FaultSchedule(
                              events=(FaultEvent("cn_drop", 32, 256, cn=0,
                                                 drop_rate=0.4),),
                              seed=3, lease_term_ops=128)), "shard"),
    "k2_cache": (StoreSpec("outback", load_factor=0.85, replicas=2,
                           cache_budget_bytes=1 << 15,
                           faults=_crash(max_retries=0)), "shard"),
    "dir_twins": (StoreSpec("outback-dir", load_factor=0.85, replicas=2,
                            faults=_dir_crash(48, 192, 0),
                            params={"initial_depth": 1}), "dir"),
    "dir_late": (StoreSpec("outback-dir", load_factor=0.85, replicas=2,
                           faults=FaultSchedule.single_crash(
                               at_op=800, duration_ops=400, mn=0,
                               lease_term_ops=128, failover_after=9),
                           params={"initial_depth": 1}), "dir"),
    "dir_hrw": (StoreSpec("outback-dir", load_factor=0.85, replicas=3,
                          placement="hrw", placement_k=2,
                          faults=_dir_crash(16, 64, 1),
                          params={"initial_depth": 1}), "dir"),
    "dir_hrw_diverged": (StoreSpec("outback-dir", load_factor=0.85,
                                   replicas=3, placement="hrw", placement_k=2,
                                   faults=_dir_crash(48, 192, 1),
                                   params={"initial_depth": 1}), "dir"),
}

POLICIES = {"sync": None, "window64": BatchPolicy(window=64)}


def with_policy(spec: StoreSpec, policy: str) -> StoreSpec:
    return StoreSpec.from_json_dict({
        **spec.to_json_dict(),
        "batch": (None if POLICIES[policy] is None
                  else POLICIES[policy].to_json_dict())})


def fault_stream(data, shape: str, seed: int = 1) -> list:
    """One seeded op stream: ``(op, *args)`` calls of the sync protocol,
    batched and scalar, over build keys and fresh keys, then a recovery
    tail of Gets that reads every written key back."""
    bk, bv, wk, wv = data
    n = len(bk)
    rng = np.random.default_rng(seed)
    out, ins = [], 0
    if shape == "shard":
        for _ in range(64):
            r = rng.random()
            if r < 0.4:
                out.append(("get_batch", bk[rng.integers(0, n, 32)]))
            elif r < 0.6:
                out.append(("insert_batch", wk[ins:ins + 8], wv[ins:ins + 8]))
                ins += 8
            elif r < 0.7:
                idx = rng.integers(0, n, 16)
                out.append(("update_batch", bk[idx], bv[idx] + np.uint64(7)))
            elif r < 0.75:
                out.append(("delete_batch", bk[rng.integers(0, n, 8)]))
            elif r < 0.85:
                out.append(("get", int(bk[rng.integers(0, n)])))
            elif r < 0.9:
                out.append(("insert", int(wk[ins]), int(wv[ins])))
                ins += 1
            elif r < 0.95:
                out.append(("update", int(bk[rng.integers(0, n)]), 5))
            else:
                out.append(("delete", int(bk[rng.integers(0, n)])))
    else:
        for i in range(24):
            out.append(("insert_batch", wk[ins:ins + 32], wv[ins:ins + 32]))
            ins += 32
            out.append(("get_batch", bk[rng.integers(0, n, 16)]))
            if i % 3 == 0:
                out.append(("update_batch", bk[i * 4:(i + 1) * 4],
                            bv[i * 4:(i + 1) * 4] + np.uint64(1)))
            if i % 5 == 0:
                out.append(("delete_batch", bk[n - 1 - i:n - i]))
                out.append(("get", int(bk[i])))
    out += [("get_batch", bk[i * 64:(i + 1) * 64]) for i in range(8)]
    out.append(("get_batch", wk[:ins]))
    return out


_KINDS = {"get_batch": "get", "insert_batch": "insert",
          "update_batch": "update", "delete_batch": "delete",
          "get": "get", "insert": "insert", "update": "update",
          "delete": "delete"}


def result_tuple(res) -> tuple:
    return (res.values.tolist(), res.found.tolist(), res.statuses,
            tuple(getattr(res, f) for f in ATTRIBUTION))


def drive(store, calls, pipelined: bool) -> list:
    """Run ``calls``: each through the sync protocol, or each submitted and
    the queue flushed at the end.  Returns one comparable tuple a call (a
    handle's lanes and its flush's attribution when pipelined)."""
    if not pipelined:
        return [result_tuple(getattr(store, op)(*args))
                for op, *args in calls]
    handles = [store.submit(_KINDS[op], *args) for op, *args in calls]
    store.flush()
    return [(result_tuple(h.result()), result_tuple(h.batch))
            for h in handles]


def replica_set(store) -> ReplicaSetAdapter:
    """The replica set under a port store's stack."""
    adapter = store
    while not isinstance(adapter, ReplicaSetAdapter):
        adapter = adapter.inner
    return adapter


def state_sig(x):
    """Canonical, comparable form of an ``mn_state`` tree (MN halves only:
    a directory store's shipped CN locators are compared elsewhere)."""
    if isinstance(x, dict):
        return tuple(sorted((k, state_sig(v)) for k, v in x.items()
                            if k != "cn"))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(state_sig(v) for v in x)
    return x
