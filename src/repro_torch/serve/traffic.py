"""``repro_torch.serve.traffic`` — the seeded open-loop traffic plane.

The port of ``repro.serve.traffic``: host numpy and Python, no device
work; the same spec gives the same ``Offered`` schedule and the same JSON
as the reference.

Every client in ``repro_torch.net.replay`` is *closed-loop*: it posts the next
op only when a previous one completes, so offered load is coupled to
completion rate and overload can never be expressed.  This module is the
missing half: a :class:`TrafficSpec` describes a multi-tenant arrival
*process* — requests arrive when the process says so, whether or not the
store has kept up — and :func:`generate` expands it into a deterministic,
time-sorted request schedule that drives both the live host path (through
``repro_torch.serve.frontdoor.FrontDoor``) and the open-loop replay
(:func:`repro_torch.net.replay.simulate_open`).

Determinism is contractual, like every plane in this repo: all draws are
splitmix64 hashes of ``(spec.seed, tenant index, stream tag, draw
counter)`` — the exact idiom ``repro_torch.net.faults`` uses — so the same spec
generates a bit-identical schedule on every run, and the spec itself is a
frozen JSON-round-trippable value that rides inside bench rows
(``BENCH_*.json`` records the traffic next to the ``StoreSpec``).

Arrival processes per tenant:

* ``"poisson"`` — homogeneous Poisson at ``rate_ops_per_s``, optionally
  modulated by the spec-level diurnal sine (thinning against the peak
  rate keeps the draw count deterministic).
* ``"mmpp"`` — a 2-state Markov-modulated Poisson process: the tenant
  alternates between a quiet state and a burst state
  (``burst_factor`` x the mean rate, ``burst_frac`` of the time, mean
  burst sojourn ``burst_mean_s``); the long-run mean stays
  ``rate_ops_per_s``.  This is the paper-adjacent "flash crowd" shape
  closed-loop clients cannot produce.

Key popularity is Zipf(``zipf_theta``) over the tenant's ``keyspace``
hottest build keys; tenants with the same ``hot_salt`` share a hot set
(the CDN-like mix singleflight feeds on), distinct salts give disjoint
hot sets (the isolation experiments).  The op mix is
``read_frac``/``insert_frac`` with updates taking the remainder.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from repro_torch.net.faults import _mix64, _unit

_ARRIVALS = ("poisson", "mmpp")
OP_KINDS = ("get", "update", "insert")


@dataclasses.dataclass(frozen=True)
class Offered:
    """One offered request: the open-loop schedule's unit.

    ``t_s`` is the arrival instant (seconds on the open-loop clock),
    ``tenant`` the offering tenant's name; ``key``/``value`` are the
    concrete 64-bit operands (``value`` is ``None`` for Gets)."""

    t_s: float
    tenant: str
    op: str
    key: int
    value: int | None = None


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's arrival process and workload mix.

    ``rate_ops_per_s`` is the long-run mean offered rate; ``read_frac``
    and ``insert_frac`` split the op mix (updates take the remainder).
    ``zipf_theta``/``keyspace``/``hot_salt`` shape key popularity:
    Zipf(theta) ranks over the ``keyspace`` hottest build keys (0 = all),
    with ``hot_salt`` rotating which build keys those ranks map to so
    tenants can share or not share a hot set.  ``arrival`` selects the
    process; the ``burst_*`` knobs only apply to ``"mmpp"``."""

    name: str
    rate_ops_per_s: float
    read_frac: float = 1.0
    insert_frac: float = 0.0
    zipf_theta: float = 0.99
    keyspace: int = 0          # 0 = the whole build key set
    hot_salt: int = 0          # tenants sharing a salt share a hot set
    arrival: str = "poisson"
    burst_factor: float = 4.0  # mmpp: burst-state rate multiplier
    burst_frac: float = 0.1    # mmpp: long-run fraction of time bursting
    burst_mean_s: float = 0.01  # mmpp: mean burst sojourn

    def validate(self) -> "TenantSpec":
        """Raise ``ValueError`` on an inexpressible tenant."""
        if not self.name:
            raise ValueError("tenant needs a non-empty name")
        if self.rate_ops_per_s <= 0:
            raise ValueError(f"tenant {self.name!r}: rate_ops_per_s must "
                             f"be > 0")
        if not (0.0 <= self.read_frac <= 1.0) \
                or not (0.0 <= self.insert_frac <= 1.0) \
                or self.read_frac + self.insert_frac > 1.0:
            raise ValueError(f"tenant {self.name!r}: need 0 <= read_frac, "
                             f"insert_frac and read_frac + insert_frac <= 1")
        if self.zipf_theta < 0:
            raise ValueError(f"tenant {self.name!r}: zipf_theta must be >= 0")
        if self.keyspace < 0:
            raise ValueError(f"tenant {self.name!r}: keyspace must be >= 0")
        if self.arrival not in _ARRIVALS:
            raise ValueError(f"tenant {self.name!r}: arrival must be one of "
                             f"{_ARRIVALS}, got {self.arrival!r}")
        if self.arrival == "mmpp":
            if self.burst_factor <= 1.0 or not (0.0 < self.burst_frac < 1.0) \
                    or self.burst_mean_s <= 0.0:
                raise ValueError(f"tenant {self.name!r}: mmpp needs "
                                 f"burst_factor > 1, 0 < burst_frac < 1 "
                                 f"and burst_mean_s > 0")
            if self.burst_factor * self.burst_frac >= 1.0:
                raise ValueError(f"tenant {self.name!r}: "
                                 f"burst_factor * burst_frac must be < 1 "
                                 f"(quiet-state rate would go negative)")
        return self

    def to_json_dict(self) -> dict:
        """Plain-JSON form (inverse of :meth:`from_json_dict`)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, d: dict) -> "TenantSpec":
        """Rebuild from :meth:`to_json_dict` output; rejects unknown keys."""
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown TenantSpec fields: {sorted(extra)}")
        return cls(**d).validate()


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """A frozen, JSON-round-trippable open-loop traffic script.

    ``tenants`` offer independently for ``duration_s`` seconds; the
    spec-level diurnal sine (amplitude ``diurnal_amp`` over period
    ``diurnal_period_s``) modulates every tenant's instantaneous rate —
    the day/night swing a production front door must ride.  ``seed``
    roots every draw; :func:`generate` is bit-identical per (spec, keys).
    """

    tenants: tuple = ()
    duration_s: float = 0.01
    seed: int = 0
    diurnal_amp: float = 0.0      # peak rate swing, in [0, 1)
    diurnal_period_s: float = 0.0  # 0 = no modulation

    def __post_init__(self):
        ts = tuple(TenantSpec.from_json_dict(t) if isinstance(t, dict) else t
                   for t in self.tenants)
        object.__setattr__(self, "tenants", ts)

    def validate(self) -> "TrafficSpec":
        """Raise ``ValueError`` on a script the generator cannot honour."""
        if not self.tenants:
            raise ValueError("TrafficSpec needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")
        for t in self.tenants:
            if not isinstance(t, TenantSpec):
                raise ValueError(f"tenants must be TenantSpec, got {type(t)}")
            t.validate()
        if self.duration_s <= 0:
            raise ValueError("duration_s must be > 0")
        if not (0.0 <= self.diurnal_amp < 1.0):
            raise ValueError("diurnal_amp must be in [0, 1)")
        if self.diurnal_amp > 0 and self.diurnal_period_s <= 0:
            raise ValueError("diurnal modulation needs diurnal_period_s > 0")
        return self

    def total_rate(self) -> float:
        """Aggregate long-run mean offered rate (ops/s) across tenants."""
        return float(sum(t.rate_ops_per_s for t in self.tenants))

    def scaled(self, factor: float) -> "TrafficSpec":
        """A copy with every tenant's mean rate scaled by ``factor`` —
        the load-sweep helper behind the goodput-vs-offered-load curve."""
        return dataclasses.replace(
            self, tenants=tuple(
                dataclasses.replace(t, rate_ops_per_s=t.rate_ops_per_s * factor)
                for t in self.tenants))

    def to_json_dict(self) -> dict:
        """Plain-JSON form (inverse of :meth:`from_json_dict`); recorded
        into bench rows next to the ``StoreSpec``."""
        d = dataclasses.asdict(self)
        d["tenants"] = [t.to_json_dict() for t in self.tenants]
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "TrafficSpec":
        """Rebuild from :meth:`to_json_dict` output; rejects unknown keys."""
        if not isinstance(d, dict):
            raise ValueError(f"TrafficSpec JSON must be an object, "
                             f"got {type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown TrafficSpec fields: {sorted(extra)}")
        d = dict(d)
        if "tenants" in d:
            d["tenants"] = tuple(d["tenants"])
        return cls(**d).validate()

    def to_json(self) -> str:
        """Canonical JSON string (sorted keys, bit-stable across runs)."""
        return json.dumps(self.to_json_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TrafficSpec":
        return cls.from_json_dict(json.loads(s))


# ------------------------------------------------------------- generation
def _zipf_cdf(n: int, theta: float) -> np.ndarray:
    """Cumulative Zipf(theta) over ranks 1..n (deterministic, no RNG)."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
    c = np.cumsum(w)
    return c / c[-1]


class _StateWalker:
    """Lazy, deterministic 2-state MMPP timeline for one tenant.

    Sojourn ``k``'s length is an exponential draw from ``_unit(seed, ti,
    2, k)``, alternating quiet (even k) and burst (odd k) states; callers
    pass monotone ``when``, so a cursor walks the timeline once."""

    def __init__(self, t: TenantSpec, seed: int, ti: int):
        self.t, self.seed, self.ti = t, seed, ti
        self.quiet_mean = t.burst_mean_s * (1.0 - t.burst_frac) / t.burst_frac
        self.edge = 0.0      # end of the current sojourn
        self.k = -1          # sojourn index (-1: before the first draw)
        self.bursting = True  # flipped to quiet by the first advance

    def _next_sojourn(self) -> None:
        self.k += 1
        self.bursting = bool(self.k % 2)  # even = quiet, odd = burst
        mean = self.t.burst_mean_s if self.bursting else self.quiet_mean
        u = _unit(self.seed, self.ti, 2, self.k)
        self.edge += -mean * math.log(max(1.0 - u, 1e-300))

    def at(self, when: float) -> bool:
        while self.edge <= when:
            self._next_sojourn()
        return self.bursting


def _tenant_stream(spec: TrafficSpec, t: TenantSpec, ti: int,
                   keys: np.ndarray) -> list[Offered]:
    """One tenant's offered requests over [0, duration_s), time-sorted."""
    seed = _mix64(spec.seed, 0x7A61F1C, ti)
    n_keys = int(keys.shape[0])
    space = min(t.keyspace, n_keys) if t.keyspace else n_keys
    cdf = _zipf_cdf(space, t.zipf_theta)
    walker = _StateWalker(t, seed, ti) if t.arrival == "mmpp" else None
    # peak instantaneous rate, for Poisson thinning: the diurnal crest
    # times the burst-state multiplier (quiet-state rate is below mean)
    lam_max = t.rate_ops_per_s * (1.0 + spec.diurnal_amp)
    if t.arrival == "mmpp":
        lam_max *= t.burst_factor
    out: list[Offered] = []
    now = 0.0
    k = 0
    two_pi = 2.0 * math.pi
    while True:
        u = _unit(seed, 0, k)
        now += -math.log(max(1.0 - u, 1e-300)) / lam_max
        if now >= spec.duration_s:
            break
        # thin the homogeneous candidate stream down to lambda(t)
        lam = t.rate_ops_per_s
        if spec.diurnal_amp > 0:
            lam *= 1.0 + spec.diurnal_amp * math.sin(
                two_pi * now / spec.diurnal_period_s)
        if walker is not None:
            if walker.at(now):
                lam *= t.burst_factor
            else:
                lam *= (1.0 - t.burst_factor * t.burst_frac) \
                    / (1.0 - t.burst_frac)
        if _unit(seed, 1, k) >= lam / lam_max:
            k += 1
            continue
        # op kind, key rank, operands — one draw stream each
        ud = _unit(seed, 3, k)
        if ud < t.read_frac:
            op = "get"
        elif ud < t.read_frac + t.insert_frac:
            op = "insert"
        else:
            op = "update"
        if op == "insert":
            # fresh derived key (collisions with live keys behave as the
            # engines' documented insert-of-existing: an update)
            key = _mix64(seed, 4, k)
            value = _mix64(seed, 5, k)
        else:
            rank = int(np.searchsorted(cdf, _unit(seed, 6, k), side="right"))
            rank = min(rank, space - 1)
            # hot_salt rotates rank -> build-key mapping: same salt, same
            # hot set (cross-tenant dedup); different salts, disjoint sets
            key = int(keys[(_mix64(0x5EED, t.hot_salt, rank)) % n_keys])
            value = _mix64(seed, 5, k) if op == "update" else None
        out.append(Offered(t_s=now, tenant=t.name, op=op, key=key,
                           value=value))
        k += 1
    return out


def generate(spec: TrafficSpec, keys: np.ndarray) -> list[Offered]:
    """Expand ``spec`` into the merged, time-sorted request schedule.

    ``keys`` is the store's build key set (Get/Update operands draw from
    it by Zipf rank).  Bit-identical per (spec, keys): every draw is a
    splitmix64 hash, the merge breaks time ties by tenant index then
    per-tenant sequence, and no wall clock or global RNG is consulted.
    """
    spec.validate()
    keys = np.asarray(keys, dtype=np.uint64)
    if keys.shape[0] == 0:
        raise ValueError("generate needs a non-empty build key set")
    streams = [_tenant_stream(spec, t, ti, keys)
               for ti, t in enumerate(spec.tenants)]
    order = {t.name: ti for ti, t in enumerate(spec.tenants)}
    merged = [r for s in streams for r in s]
    merged.sort(key=lambda r: (r.t_s, order[r.tenant]))
    return merged


__all__ = ["OP_KINDS", "Offered", "TenantSpec", "TrafficSpec", "generate"]
