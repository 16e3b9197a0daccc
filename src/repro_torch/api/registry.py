"""``StoreSpec`` + ``open_store``: the port's store factory.

The port of ``repro.api.registry``.  :class:`StoreSpec` keeps the
reference's fields and JSON exactly, so one spec's JSON opens the same
store in both packages.  ``open_store(spec, keys, values, device=...,
transport=...)`` builds the engine on ``device`` (CUDA unless the caller
passes ``device="cpu"``; it raises when CUDA is absent) and assembles the
CN stack ``Pipeline → Meter → [CNCache →] [Retry →] adapter (→
Transport)`` around it; a spec's ``cache_budget_bytes`` builds the stack's
``CNKeyCache`` on the same device, ``replicas > 1`` or a ``faults``
schedule builds K replicas behind a
``repro_torch.api.replication.ReplicaSetAdapter`` with the retry stage
above it, and a ``repro_torch.net.Transport`` records the store's op
trace.

Registered kinds:

=============  ==========================================================
``outback``     one Outback DMPH shard (§4.3 protocols)
``outback-dir`` extendible-hashing directory of shards + §4.4 resize
``race``        one-sided RACE baseline (2-RT Get, zero MN compute)
``mica``        two-sided RPC-MICA baseline (linear probing, MN-heavy)
``cluster``     two-sided RPC-Cluster baseline (chained buckets)
``dummy``       RPC-Dummy upper bound (one fixed MN read per op)
``sharded``     Outback sharded over a mesh of ranks (host adapter + the
                mesh state of ``repro_torch.core.sharded_kvs``)
=============  ==========================================================

Every kind of the reference is served, and so are its failure plane
(replication, fault schedules, placement ``'hrw'``) and its telemetry
plane (``telemetry``, a :class:`repro_torch.obs.TelemetryConfig`), with
the reference's checks.
"""

from __future__ import annotations

import dataclasses
import json
import typing

import numpy as np

from repro_torch.api import adapters
from repro_torch.api.pipeline import BatchPolicy
from repro_torch.api.replication import ReplicaPlacement, ReplicaSetAdapter
from repro_torch.api.stack import CNStack, TransportBinding
from repro_torch.core.baselines import ClusterKVS, DummyKVS, MicaKVS, RaceKVS
from repro_torch.core.cn_cache import CNKeyCache
from repro_torch.core.outback import OutbackShard, resolve_device
from repro_torch.core.sharded_kvs import build_sharded
from repro_torch.core.store import OutbackStore
from repro_torch.net.faults import CN_TARGET_KINDS, FaultPlane, FaultSchedule
from repro_torch.obs import TelemetryConfig, TelemetryHub


class SpecError(ValueError):
    """A StoreSpec that cannot be built: unknown kind / param / value."""


# Kinds whose engines export the mn_state()/install_mn_state() replication
# surface (the memory-heavy MN half is shippable); replicas > 1 and fault
# schedules are restricted to these.
_REPLICABLE_KINDS = frozenset(("outback", "outback-dir"))


@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """Pure-config description of a store; JSON-round-trippable, with the
    same fields and JSON as ``repro.api.StoreSpec``."""

    kind: str
    load_factor: float | None = None  # None -> the kind's native default
    rng_seed: int = 0
    cache_budget_bytes: int = 0  # CN hot-key cache budget; 0 disables
    # submission-plane batching policy (a BatchPolicy or its JSON dict);
    # None -> the synchronous behaviour (window=1)
    batch: BatchPolicy | None = None
    params: dict = dataclasses.field(default_factory=dict)  # kind-specific
    # failure plane (repro_torch.net.faults / repro_torch.api.replication):
    # K-way replication of the MN half, and a deterministic fault schedule
    # (a FaultSchedule or its JSON dict); the defaults (1, None) build the
    # plain store
    replicas: int = 1
    faults: FaultSchedule | None = None
    # replica placement: "twins" mirrors the whole MN image onto every
    # replica (the default); "hrw" places each directory shard on
    # ``placement_k`` of the ``replicas`` MNs by seeded rendezvous hashing
    # (outback-dir only)
    placement: str = "twins"
    placement_k: int = 1
    # telemetry plane (repro_torch.obs): a TelemetryConfig (or its JSON
    # dict) makes open_store assemble an instrumented stack with a
    # TelemetryHub; None (the default) keeps the plane dormant — meters,
    # traces and final store state stay byte-identical
    telemetry: TelemetryConfig | None = None

    def __post_init__(self):
        if isinstance(self.batch, dict):  # JSON round-trip normalisation
            try:
                object.__setattr__(self, "batch",
                                   BatchPolicy.from_json_dict(self.batch))
            except ValueError as e:
                raise SpecError(str(e)) from e
        if isinstance(self.faults, dict):
            try:
                object.__setattr__(self, "faults",
                                   FaultSchedule.from_json_dict(self.faults))
            except ValueError as e:
                raise SpecError(str(e)) from e
        if isinstance(self.telemetry, dict):
            try:
                object.__setattr__(
                    self, "telemetry",
                    TelemetryConfig.from_json_dict(self.telemetry))
            except ValueError as e:
                raise SpecError(str(e)) from e

    # ------------------------------------------------------------- json
    def to_json_dict(self) -> dict:
        return {"kind": self.kind, "load_factor": self.load_factor,
                "rng_seed": self.rng_seed,
                "cache_budget_bytes": self.cache_budget_bytes,
                "batch": (None if self.batch is None
                          else self.batch.to_json_dict()),
                "params": dict(self.params),
                "replicas": self.replicas,
                "faults": (None if self.faults is None
                           else self.faults.to_json_dict()),
                "placement": self.placement,
                "placement_k": self.placement_k,
                "telemetry": (None if self.telemetry is None
                              else self.telemetry.to_json_dict())}

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)

    @classmethod
    def from_json_dict(cls, d: dict) -> "StoreSpec":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise SpecError(f"unknown StoreSpec fields: {sorted(unknown)}")
        if "kind" not in d:
            raise SpecError("StoreSpec JSON must carry 'kind'")
        return cls(**{**d, "params": dict(d.get("params") or {})})

    @classmethod
    def from_json(cls, s: str) -> "StoreSpec":
        return cls.from_json_dict(json.loads(s))

    # ------------------------------------------------------- validation
    def validate(self) -> "_StoreKind":
        """Check against the registry; returns the kind's registration."""
        reg = _REGISTRY.get(self.kind)
        if reg is None:
            raise SpecError(
                f"unknown store kind {self.kind!r}; registered kinds: "
                f"{', '.join(registered_kinds())}")
        unknown = set(self.params) - reg.params
        if unknown:
            raise SpecError(
                f"unknown params for kind {self.kind!r}: {sorted(unknown)}; "
                f"allowed: {sorted(reg.params) or '(none)'}")
        if self.load_factor is not None and not 0.0 < self.load_factor <= 1.0:
            raise SpecError(f"load_factor must be in (0, 1], "
                            f"got {self.load_factor}")
        if self.cache_budget_bytes and self.cache_budget_bytes < 1024:
            raise SpecError("cache_budget_bytes below 1 KiB is meaningless "
                            "(0 disables the CN cache)")
        if self.batch is not None:
            if not isinstance(self.batch, BatchPolicy):
                raise SpecError(f"batch must be a BatchPolicy (or its JSON "
                                f"dict), got {type(self.batch).__name__}")
            try:
                self.batch.validate()
            except ValueError as e:
                raise SpecError(str(e)) from e
        if not isinstance(self.replicas, int) or self.replicas < 1:
            raise SpecError(f"replicas must be an int >= 1, "
                            f"got {self.replicas!r}")
        if ((self.replicas > 1 or self.faults is not None)
                and self.kind not in _REPLICABLE_KINDS):
            raise SpecError(
                f"replication/faults need a kind exporting mn_state "
                f"(one of {sorted(_REPLICABLE_KINDS)}), got {self.kind!r}")
        if self.faults is not None:
            if not isinstance(self.faults, FaultSchedule):
                raise SpecError(f"faults must be a FaultSchedule (or its "
                                f"JSON dict), got "
                                f"{type(self.faults).__name__}")
            try:
                self.faults.validate()
            except ValueError as e:
                raise SpecError(str(e)) from e
            for ev in self.faults.events:
                # CN-targeting kinds name a compute node, not an MN
                # replica; open_store (one CN) validates those instead
                if ev.kind not in ("cn_crash", "cn_delay", "cn_drop") \
                        and ev.mn >= self.replicas:
                    raise SpecError(
                        f"{ev.kind} fault event targets MN {ev.mn} but "
                        f"the spec deploys {self.replicas} replica(s)")
        if self.placement not in ("twins", "hrw"):
            raise SpecError(f"placement must be 'twins' or 'hrw', "
                            f"got {self.placement!r}")
        if not isinstance(self.placement_k, int) or self.placement_k < 1:
            raise SpecError(f"placement_k must be an int >= 1, "
                            f"got {self.placement_k!r}")
        if self.placement == "hrw":
            if self.kind != "outback-dir":
                raise SpecError("placement='hrw' is a per-directory-shard "
                                "policy; it needs kind='outback-dir'")
            if self.placement_k > self.replicas:
                raise SpecError(
                    f"placement_k={self.placement_k} exceeds the "
                    f"{self.replicas} deployed replica(s)")
        if self.telemetry is not None:
            if not isinstance(self.telemetry, TelemetryConfig):
                raise SpecError(f"telemetry must be a TelemetryConfig (or "
                                f"its JSON dict), got "
                                f"{type(self.telemetry).__name__}")
            try:
                self.telemetry.validate()
            except ValueError as e:
                raise SpecError(str(e)) from e
        return reg

    def merged_params(self) -> dict:
        """Kind defaults overlaid with the spec's explicit params."""
        reg = self.validate()
        return {**reg.defaults, **self.params}


@dataclasses.dataclass(frozen=True)
class _StoreKind:
    name: str
    factory: typing.Callable  # (spec, keys, values, device, transport)
    params: frozenset  # allowed keys of spec.params
    defaults: dict  # params applied when the spec omits them
    doc: str


_REGISTRY: dict[str, _StoreKind] = {}


def register_store(name: str, factory, *, params=(), defaults=None,
                   doc: str = "") -> None:
    """Add a kind to the registry (idempotent only for identical entries:
    re-registering the same kind with different contents raises)."""
    kind = _StoreKind(name, factory, frozenset(params),
                      dict(defaults or {}), doc)
    existing = _REGISTRY.get(name)
    if existing is not None:
        if existing == kind:
            return
        raise SpecError(f"store kind {name!r} already registered "
                        f"with different contents")
    _REGISTRY[name] = kind


def registered_kinds() -> tuple[str, ...]:
    """All registered kind names, sorted."""
    return tuple(sorted(_REGISTRY))


def registry_docs() -> dict[str, str]:
    """``{kind: one-line doc}`` for every registered kind."""
    return {k: _REGISTRY[k].doc for k in registered_kinds()}


def open_store(spec: StoreSpec, keys, values, *, device=None, transport=None):
    """Build the spec's engine on ``device`` and assemble the CN stack.

    ``device=None`` means CUDA and raises when no card is present: the
    port runs on the CPU only when the caller passes ``device="cpu"``.
    Returns a ``PipelinedKVStore`` (Pipeline → Meter → [CNCache →]
    [Retry →] adapter), with the pipeline shaped by ``spec.batch``
    (synchronous when the spec carries none) and a CN hot-key cache of
    ``spec.cache_budget_bytes`` on the engine's device when that is not 0.
    ``transport``, an optional ``repro_torch.net.Transport``, is bound
    below the engine as the stack's recording stage (every engine meter's
    sink) and receives the pipeline's doorbell marks.

    When the spec carries ``replicas > 1`` or a ``faults`` schedule, the
    factory is invoked once per replica (same spec + seed ⇒ identical
    twins, each on ``device``) and the set is wrapped in a
    :class:`ReplicaSetAdapter` driven by one
    :class:`repro_torch.net.faults.FaultPlane`; the stack then inserts its
    ``RetryLayer`` above it.  A replicas-only spec (no schedule) gets a
    dormant plane with leasing off, so its meter totals match the
    unreplicated store byte for byte.  The store models one CN (CN 0):
    events that target another CN raise.

    When the spec carries a ``telemetry`` config, a
    :class:`repro_torch.obs.TelemetryHub` is built and threaded through
    every stack layer (the returned store's ``telemetry``), with
    dim-tagged wire sinks fanned out to each replica's and each shard's
    meter.  The hub only observes: meters, traces and final store state
    stay byte-identical to a telemetry-off build, and it adds no device
    op."""
    if spec.faults is not None:
        for ev in spec.faults.events:
            if ev.kind in CN_TARGET_KINDS and ev.cn >= 1:
                raise SpecError(
                    f"{ev.kind} fault event targets CN {ev.cn} but "
                    f"open_store deploys a single CN (CN 0); use "
                    f"repro_torch.cluster for multi-CN deployments")
    device = resolve_device(device)
    adapter, retry = build_adapter(spec, keys, values, device=device,
                                   transport=transport)
    hub = None
    if spec.telemetry is not None:
        hub = TelemetryHub(spec.telemetry)
        _bind_hub_sinks(adapter, hub)
    cache = (CNKeyCache(spec.cache_budget_bytes, device=device)
             if spec.cache_budget_bytes else None)
    return CNStack(cache=cache,
                   transport_binding=TransportBinding(transport),
                   policy=spec.batch, retry=retry, hub=hub).assemble(adapter)


def _bind_hub_sinks(adapter, hub) -> None:
    """Fan dim-tagged hub wire sinks out to every meter under ``adapter``.

    Replica sets get an ``mn=<i>`` dim per replica (plus a CN-ledger
    sink for failover/lease wire); sharded hosts get ``shard=<i>`` per
    shard; directory stores get ``shard=dir`` for the directory meter and
    a per-table factory that survives §4.4 splits and resyncs."""
    if isinstance(adapter, ReplicaSetAdapter):
        adapter._meter.add_sink(hub.wire_sink(mn="cn"))
        for i, rep in enumerate(adapter.replicas):
            _bind_engine_sinks(rep, hub, {"mn": i})
        return
    _bind_engine_sinks(adapter, hub, {})


def _bind_engine_sinks(adp, hub, dims: dict) -> None:
    shards = getattr(adp, "shards", None)
    if shards is not None:  # sharded host adapter: per-shard dims
        adp._meter.add_sink(hub.wire_sink(**dims, shard="host"))
        for i, sh in enumerate(shards):
            sh.meter.add_sink(hub.wire_sink(**dims, shard=i))
        return
    eng = adp.engine
    if hasattr(eng, "bind_table_sinks"):  # outback-dir: per-table dims
        eng.meter.add_sink(hub.wire_sink(**dims, shard="dir"))
        eng.bind_table_sinks(
            lambda i, d=dict(dims): hub.wire_sink(**d, shard=i))
        return
    eng.meter.add_sink(hub.wire_sink(**dims))


def build_adapter(spec: StoreSpec, keys, values, *, device=None,
                  transport=None):
    """Build the spec's engine adapter without the CN stack around it.

    Returns ``(adapter, retry_plane)``: the engine adapter (wrapped in a
    :class:`ReplicaSetAdapter` when the spec carries replication or a fault
    schedule) and the :class:`FaultPlane` the stack's retry stage must
    consult (``None`` when no plane is installed)."""
    reg = spec.validate()
    device = resolve_device(device)
    keys = np.asarray(keys, dtype=np.uint64)
    values = np.asarray(values, dtype=np.uint64)
    if keys.shape != values.shape:
        raise SpecError(f"keys/values shape mismatch: "
                        f"{keys.shape} vs {values.shape}")
    adapter = reg.factory(spec, keys, values, device, transport)
    retry = None
    if spec.replicas > 1 or spec.faults is not None:
        group = [adapter] + [reg.factory(spec, keys, values, device,
                                         transport)
                             for _ in range(spec.replicas - 1)]
        plane = FaultPlane(spec.faults if spec.faults is not None
                           else FaultSchedule(lease_term_ops=0))
        placement = None
        if spec.placement == "hrw" and spec.replicas > 1:
            # one replica makes placement the identity map; skip it so the
            # serve path (and its metering) stays the plain one
            placement = ReplicaPlacement(len(adapter.engine.tables),
                                         spec.replicas, spec.placement_k,
                                         seed=spec.rng_seed)
        adapter = ReplicaSetAdapter(group, spec, plane, transport=transport,
                                    placement=placement)
        retry = plane
    return adapter, retry


# ---------------------------------------------------------------------------
# built-in kinds


def _common_kw(spec: StoreSpec) -> dict:
    kw = dict(spec.merged_params())
    if spec.load_factor is not None:
        kw["load_factor"] = spec.load_factor
    kw["rng_seed"] = spec.rng_seed
    return kw


def _outback_factory(spec, keys, values, device, transport):
    eng = OutbackShard(keys, values, device=device, transport=transport,
                       **_common_kw(spec))
    return adapters.OutbackShardAdapter(eng, spec)


def _outback_dir_factory(spec, keys, values, device, transport):
    eng = OutbackStore(keys, values, device=device, transport=transport,
                       **_common_kw(spec))
    return adapters.OutbackStoreAdapter(eng, spec)


def _baseline_factory(cls, adapter_cls, kind):
    def factory(spec, keys, values, device, transport):
        eng = cls(keys, values, device=device, transport=transport,
                  **_common_kw(spec))
        adp = adapter_cls(eng, spec)
        adp.kind = kind
        return adp
    return factory


def _sharded_factory(spec, keys, values, device, transport):
    kw = _common_kw(spec)
    D = int(kw.pop("data_parallel"))
    st = build_sharded(keys, values, data_parallel=D, transport=transport,
                       keep_shards=True, device=device, **kw)
    return adapters.ShardedAdapter(st, spec, shards=st.shards,
                                   data_parallel=D)


register_store(
    "outback", _outback_factory,
    params=("heap_slack", "overflow_frac", "num_buckets", "oth_ma", "oth_mb",
            "heap_cap"),
    doc="one Outback DMPH shard: CN/MN split + the §4.3 1-RT protocols")
register_store(
    "outback-dir", _outback_dir_factory,
    params=("initial_depth", "num_compute_nodes"),
    doc="extendible-hashing directory of Outback shards + §4.4 resizing")
register_store(
    "race", _baseline_factory(RaceKVS, adapters.RaceAdapter, "race"),
    doc="one-sided RACE baseline: 2-RT Get, zero MN compute")
register_store(
    "mica", _baseline_factory(MicaKVS, adapters.BaselineAdapter, "mica"),
    doc="two-sided RPC-MICA baseline: linear probing, MN-heavy scans")
register_store(
    "cluster",
    _baseline_factory(ClusterKVS, adapters.BaselineAdapter, "cluster"),
    doc="two-sided RPC-Cluster baseline: chained associative buckets")
register_store(
    "dummy", _baseline_factory(DummyKVS, adapters.DummyAdapter, "dummy"),
    doc="RPC-Dummy upper bound: one fixed MN read per op")
register_store(
    "sharded", _sharded_factory,
    params=("num_shards", "data_parallel", "heap_slack"),
    defaults={"num_shards": 2, "data_parallel": 1},
    doc="Outback sharded over a device mesh (host adapter + mesh state)")
