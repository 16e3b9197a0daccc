"""``repro_torch.net`` — the discrete-event RDMA transport simulator.

The port of ``repro.net`` with its fault plane (``faults``) and without
its chaos harness (``chaos``): host Python and numpy, no device work.
Turns the per-op counters every KVS feeds its
:class:`repro_torch.core.meter.CommMeter` into *time*: per-op latency
distributions, closed-loop throughput versus client count,
doorbell-batching effects and resize-dip timelines.

Usage::

    from repro_torch.net import Transport, simulate
    tr = Transport()
    store = open_store(StoreSpec("race"), keys, vals, transport=tr)
    store.get_batch(queries)
    res = simulate(tr.trace, clients=8, mn_threads=1)
    res.percentiles()            # {'p50_us': ..., 'p99_us': ..., ...}
    res.tput_mops                # closed-loop modelled throughput

Passing ``transport=None`` (the default everywhere) leaves every KVS
byte-for-byte on the plain metered path: the simulator only observes.

The host plane decides fault outcomes (:class:`FaultPlane`, over a seeded
:class:`FaultSchedule` of :class:`FaultEvent` windows that rides inside
``StoreSpec``), and the replay times them (``simulate(replicas=K)`` plus
the ``FaultMark`` windows in the trace).
Given the same trace, every result equals the reference's exactly (no
wall clock and no RNG in any event path).
"""

from repro_torch.net.faults import FaultEvent, FaultPlane, FaultSchedule
from repro_torch.net.replay import (SimResult, simulate, simulate_cluster,
                                    simulate_open)
from repro_torch.net.service import CX3, CX6, ServiceModel
from repro_torch.net.sim import Server, Simulator
from repro_torch.net.transport import (DoorbellMark, FaultMark, OpEvent,
                                       ResizeMark, Segment, Transport)

__all__ = ["CX3", "CX6", "DoorbellMark", "FaultEvent", "FaultMark",
           "FaultPlane", "FaultSchedule", "OpEvent", "ResizeMark", "Segment",
           "Server", "ServiceModel", "SimResult", "Simulator", "Transport",
           "simulate", "simulate_cluster", "simulate_open"]
