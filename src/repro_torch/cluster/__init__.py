"""``repro_torch.cluster`` — the multi-CN plane over one shared MN pool.

The port of ``repro.cluster``.  N per-CN stacks (own transport, meter
ledger, CN cache, pipeline, telemetry dims ``cn=i``) share one MN pool,
the engine adapter that ``repro_torch.api.registry.build_adapter`` builds
on the device, so every CN's miss flush goes through the port's kernels.
Three cluster-only mechanisms sit on top, all host-plane bookkeeping:

* **elastic membership** (:mod:`repro_torch.cluster.membership`) — a
  seeded, op-clock join/leave/crash script, deterministic like
  ``repro_torch.net.faults``;
* **shard-ownership handoff** (:mod:`repro_torch.cluster.ownership`) —
  rendezvous-hashed directory-shard -> CN placement whose rebalance
  moves only affected shards' CN half (DMPH seeds + othello arrays),
  lease-gated like a replica failover: O(shards moved), never O(keys);
* **cross-CN cache coherence** (:mod:`repro_torch.cluster.coherence`) —
  per-shard invalidation epochs multicast on writes' existing round
  trips; non-owners serve cached reads only after the epoch check and
  forward writes to the owner.

The plane is **dormant** by construction: ``Cluster`` with one CN and an
empty schedule is byte-identical to ``repro_torch.api.open_store`` —
same CommMeter totals, same trace, same final MN state.  Given the same
spec, keys and op stream, a cluster gives the reference's answers,
meters, traces, ``ClusterStats``, handoffs and MN state.
"""

from repro_torch.cluster.cluster import (CNRouter, Cluster, ClusterSpec,
                                         ClusterStats, EpochGate,
                                         HandoffEvent, SwitchingTransport,
                                         cluster_of)
from repro_torch.cluster.coherence import ShardEpochs
from repro_torch.cluster.membership import (MembershipEvent,
                                            MembershipSchedule)
from repro_torch.cluster.ownership import OwnershipTable

__all__ = [
    "CNRouter",
    "Cluster",
    "ClusterSpec",
    "ClusterStats",
    "EpochGate",
    "HandoffEvent",
    "MembershipEvent",
    "MembershipSchedule",
    "OwnershipTable",
    "ShardEpochs",
    "SwitchingTransport",
    "cluster_of",
]
