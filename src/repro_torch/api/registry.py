"""``StoreSpec`` + ``open_store``: the port's store factory.

The port of ``repro.api.registry``.  :class:`StoreSpec` keeps the
reference's fields and JSON exactly, so one spec's JSON opens the same
store in both packages.  ``open_store(spec, keys, values, device=...,
transport=...)`` builds the engine on ``device`` (CUDA unless the caller
passes ``device="cpu"``; it raises when CUDA is absent) and assembles the
CN stack ``Pipeline → Meter → [CNCache →] adapter (→ Transport)`` around
it; a spec's ``cache_budget_bytes`` builds the stack's ``CNKeyCache`` on
the same device, and a ``repro_torch.net.Transport`` records the store's
op trace.

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

Every kind of the reference is served.  The options served by planes not
ported yet (replication, fault schedules, placement ``'hrw'``, telemetry)
raise :class:`SpecError` saying so.
"""

from __future__ import annotations

import dataclasses
import json
import typing

import numpy as np

from repro_torch.api import adapters
from repro_torch.api.pipeline import BatchPolicy
from repro_torch.api.stack import CNStack, TransportBinding
from repro_torch.core.baselines import ClusterKVS, DummyKVS, MicaKVS, RaceKVS
from repro_torch.core.cn_cache import CNKeyCache
from repro_torch.core.outback import OutbackShard, resolve_device
from repro_torch.core.sharded_kvs import build_sharded
from repro_torch.core.store import OutbackStore


class SpecError(ValueError):
    """A StoreSpec that cannot be built: unknown kind / param / value, or
    an option this package has not ported yet."""


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
    # failure plane (not ported): K-way MN replication and a fault
    # schedule, kept as given so the JSON round-trips
    replicas: int = 1
    faults: typing.Any = None
    placement: str = "twins"
    placement_k: int = 1
    # telemetry plane (not ported): kept as given so the JSON round-trips
    telemetry: typing.Any = None

    def __post_init__(self):
        if isinstance(self.batch, dict):  # JSON round-trip normalisation
            try:
                object.__setattr__(self, "batch",
                                   BatchPolicy.from_json_dict(self.batch))
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
                "faults": _json_of(self.faults),
                "placement": self.placement,
                "placement_k": self.placement_k,
                "telemetry": _json_of(self.telemetry)}

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
        if self.placement not in ("twins", "hrw"):
            raise SpecError(f"placement must be 'twins' or 'hrw', "
                            f"got {self.placement!r}")
        if not isinstance(self.placement_k, int) or self.placement_k < 1:
            raise SpecError(f"placement_k must be an int >= 1, "
                            f"got {self.placement_k!r}")
        for name, unported in (
                ("replicas > 1 (MN replication)", self.replicas > 1),
                ("faults (the failure plane)", self.faults is not None),
                ("placement='hrw'", self.placement == "hrw"),
                ("telemetry (the telemetry plane)",
                 self.telemetry is not None)):
            if unported:
                raise SpecError(f"{name} is not yet ported to repro_torch "
                                f"(kind {self.kind!r})")
        return reg

    def merged_params(self) -> dict:
        """Kind defaults overlaid with the spec's explicit params."""
        reg = self.validate()
        return {**reg.defaults, **self.params}


def _json_of(x):
    return x.to_json_dict() if hasattr(x, "to_json_dict") else x


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
    adapter), with the pipeline shaped by ``spec.batch`` (synchronous when
    the spec carries none) and a CN hot-key cache of
    ``spec.cache_budget_bytes`` on the engine's device when that is not 0.
    ``transport``, an optional ``repro_torch.net.Transport``, is bound
    below the engine as the stack's recording stage (every engine meter's
    sink) and receives the pipeline's doorbell marks."""
    device = resolve_device(device)
    adapter = build_adapter(spec, keys, values, device=device,
                            transport=transport)
    cache = (CNKeyCache(spec.cache_budget_bytes, device=device)
             if spec.cache_budget_bytes else None)
    return CNStack(cache=cache,
                   transport_binding=TransportBinding(transport),
                   policy=spec.batch).assemble(adapter)


def build_adapter(spec: StoreSpec, keys, values, *, device=None,
                  transport=None):
    """Build the spec's engine adapter without the CN stack around it."""
    reg = spec.validate()
    device = resolve_device(device)
    keys = np.asarray(keys, dtype=np.uint64)
    values = np.asarray(values, dtype=np.uint64)
    if keys.shape != values.shape:
        raise SpecError(f"keys/values shape mismatch: "
                        f"{keys.shape} vs {values.shape}")
    return reg.factory(spec, keys, values, device, transport)


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
