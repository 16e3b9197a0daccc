"""Serving: the continuous-batching ``Engine`` over ``models.lm.LM``, the
session store that parks lanes through the Outback KVS, the open-loop
traffic plane and the front door."""

from repro_torch.serve.engine import Engine, EngineStats, Request
from repro_torch.serve.frontdoor import (FDRecord, FrontDoor, FrontDoorConfig,
                                         TenantLimit)
from repro_torch.serve.session_store import KVSessionStore
from repro_torch.serve.traffic import (Offered, TenantSpec, TrafficSpec,
                                       generate)

__all__ = ["Engine", "EngineStats", "FDRecord", "FrontDoor",
           "FrontDoorConfig", "KVSessionStore", "Offered", "Request",
           "TenantLimit", "TenantSpec", "TrafficSpec", "generate"]
