"""``repro_torch.api`` — one KVStore protocol, a CN stack, a registry.

The port of ``repro.api`` for kind ``outback``:

* :mod:`repro_torch.api.protocol` — :class:`KVStore`,
  :class:`PipelinedKVStore` and the :class:`OpResult` every op returns;
* :mod:`repro_torch.api.pipeline` — :class:`BatchPolicy`, ``submit`` /
  ``poll`` / ``flush`` and :class:`OpHandle`;
* :mod:`repro_torch.api.stack` — ``Pipeline → Meter → adapter``;
* :mod:`repro_torch.api.registry` — :class:`StoreSpec` (the reference's
  JSON) and :func:`open_store`.
"""

from repro_torch.api.adapters import OutbackShardAdapter, StoreAdapter
from repro_torch.api.pipeline import (BatchPolicy, OpHandle, PipelineLayer,
                                      PipelineStats)
from repro_torch.api.protocol import (OP_KINDS, KVStore, OpResult,
                                      PipelinedKVStore, UnsupportedOperation,
                                      pack_result)
from repro_torch.api.registry import (SpecError, StoreSpec, build_adapter,
                                      open_store, register_store,
                                      registered_kinds, registry_docs)
from repro_torch.api.stack import (CNStack, MeterLayer, StoreLayer,
                                   TransportBinding)

__all__ = [
    "BatchPolicy",
    "CNStack",
    "KVStore",
    "MeterLayer",
    "OP_KINDS",
    "OpHandle",
    "OpResult",
    "OutbackShardAdapter",
    "PipelineLayer",
    "PipelineStats",
    "PipelinedKVStore",
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
