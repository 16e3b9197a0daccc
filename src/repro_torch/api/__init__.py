"""``repro_torch.api`` — one KVStore protocol, a CN stack, a registry.

The port of ``repro.api`` for every kind of the reference: ``outback``,
``outback-dir``, ``race``, ``mica``, ``cluster``, ``dummy`` and
``sharded``:

* :mod:`repro_torch.api.protocol` — :class:`KVStore`,
  :class:`PipelinedKVStore` and the :class:`OpResult` every op returns;
* :mod:`repro_torch.api.pipeline` — :class:`BatchPolicy`, ``submit`` /
  ``poll`` / ``flush`` and :class:`OpHandle`;
* :mod:`repro_torch.api.stack` — ``Pipeline → Meter → [CNCache →]
  [Retry →] adapter``, with :class:`RetryLayer` (timeout, seeded jittered
  backoff, failover, degraded ``"unavailable"`` answers);
* :mod:`repro_torch.api.replication` — :class:`ReplicaSetAdapter` (K-way
  replication of the memory-heavy MN half, CN-driven failover, resync,
  leases through :class:`ShardLease`), driven by a
  :class:`repro_torch.net.FaultSchedule` carried on the spec;
* :mod:`repro_torch.api.registry` — :class:`StoreSpec` (the reference's
  JSON) and :func:`open_store`.
"""

from repro_torch.api.adapters import (BaselineAdapter, DummyAdapter,
                                      OutbackShardAdapter,
                                      OutbackStoreAdapter, RaceAdapter,
                                      ShardedAdapter, StoreAdapter)
from repro_torch.api.pipeline import (BatchPolicy, OpHandle, PipelineLayer,
                                      PipelineStats)
from repro_torch.api.protocol import (OP_KINDS, KVStore, OpResult,
                                      PipelinedKVStore, UnsupportedOperation,
                                      pack_result)
from repro_torch.api.replication import ReplicaSetAdapter, ShardLease
from repro_torch.api.registry import (SpecError, StoreSpec, build_adapter,
                                      open_store, register_store,
                                      registered_kinds, registry_docs)
from repro_torch.api.stack import (CNCacheLayer, CNStack, MeterLayer,
                                   RetryLayer, StoreLayer, TransportBinding)

__all__ = [
    "BaselineAdapter",
    "BatchPolicy",
    "CNCacheLayer",
    "CNStack",
    "DummyAdapter",
    "KVStore",
    "MeterLayer",
    "OP_KINDS",
    "OpHandle",
    "OpResult",
    "OutbackShardAdapter",
    "OutbackStoreAdapter",
    "PipelineLayer",
    "PipelineStats",
    "PipelinedKVStore",
    "RaceAdapter",
    "ReplicaSetAdapter",
    "RetryLayer",
    "ShardLease",
    "ShardedAdapter",
    "SpecError",
    "StoreAdapter",
    "StoreLayer",
    "StoreSpec",
    "TransportBinding",
    "UnsupportedOperation",
    "build_adapter",
    "open_store",
    "pack_result",
    "register_store",
    "registered_kinds",
    "registry_docs",
]
