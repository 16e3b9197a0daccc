"""Hardware service models: how long each simulated component holds a job.

The port of ``repro.net.service``, constant for constant.

Every constant is a *rate*, not a measurement — the absolute numbers are
calibrated so that the modeled single-client Get latency and the saturated
single-MN-thread throughput land in the range the paper reports for its
CX-6 testbed (§5.1: ~2 us one-RT Get, Outback ~3.5 Mops/thread, RACE
plateauing near 4.5 Mops at 2 RTs/op), and so that the *ratios* between
schemes — the reproduced claims — are driven entirely by the per-op
counter profile each KVS feeds its
:class:`repro_torch.core.meter.CommMeter`.

Component map (one ``Segment`` = one round trip of an op):

* CN client CPU: ``cn_hash_s``/``cn_cmp_s`` per counted op, paid once
  before the first post; ``cn_post_s`` per verb posting (WQE build + MMIO
  doorbell), amortised to ``cn_post_batched_s`` for verbs that ride an
  earlier doorbell (doorbell batching, §2/Fig. 2 of the RDMA-RPC
  literature).
* Wire: fixed one-way propagation+switch delay ``wire_s``.
* MN NIC: per-message processing plus a bytes term; one-sided READs also
  occupy the RNIC read engine for ``nic_verb_s`` (QP-state fetch + DMA —
  this is what caps RACE near RNIC_VERB_MOPS without touching the CPU).
* MN CPU (two-sided RPC only): ``mn_poll_s`` poll+post per message (the
  same constant as ``benchmarks.common.RPC_OVERHEAD_S``) plus the op's
  metered hash/compare/memory work.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    # wire / NIC
    wire_s: float = 0.8e-6        # one-way propagation + switch
    nic_fixed_s: float = 25e-9    # per-message NIC processing
    nic_byte_s: float = 1 / 25e9  # 200 Gb/s line rate
    nic_verb_s: float = 85e-9     # RNIC read-engine occupancy per 1-sided verb
    # CN client CPU
    cn_post_s: float = 450e-9         # WQE build + doorbell MMIO, unbatched
    cn_post_batched_s: float = 60e-9  # extra WQE riding an earlier doorbell
    max_doorbell: int = 8             # WQEs one doorbell ring may cover
    cn_hash_s: float = 5e-9
    cn_cmp_s: float = 2e-9
    # MN CPU (the scarce resource)
    mn_poll_s: float = 150e-9  # RPC poll + post per message (== RPC_OVERHEAD_S)
    mn_hash_s: float = 20e-9
    mn_cmp_s: float = 8e-9
    mn_read_s: float = 60e-9   # dependent DRAM access
    mn_write_s: float = 60e-9
    # resize modeling: MN CPU-seconds per live key to rebuild a DMPH table
    # (paper §5.9: ~3 s for 20 M keys on one MN thread -> 150 ns/key)
    rebuild_per_key_s: float = 150e-9
    resize_slow_factor: float = 2.0  # serving slowdown while rebuilding (~50%)

    # ------------------------------------------------------------ per-piece
    def cn_compute_s(self, cn_hash: int, cn_cmp: int) -> float:
        return cn_hash * self.cn_hash_s + cn_cmp * self.cn_cmp_s

    def mn_cpu_s(self, seg) -> float:
        """MN CPU occupancy for one two-sided request (0 for one-sided)."""
        if seg.one_sided:
            return 0.0
        return (self.mn_poll_s + seg.mn_hash * self.mn_hash_s
                + seg.mn_cmp * self.mn_cmp_s + seg.mn_reads * self.mn_read_s
                + seg.mn_writes * self.mn_write_s)

    def mn_nic_s(self, seg) -> float:
        """MN NIC occupancy: message processing + bytes (+ read engine)."""
        t = self.nic_fixed_s + (seg.req_bytes + seg.resp_bytes) * self.nic_byte_s
        if seg.one_sided:
            t += seg.verbs * self.nic_verb_s
        return t

    def cn_recv_s(self, seg) -> float:
        """Local completion-side delay at the CN NIC (not a shared queue)."""
        return self.nic_fixed_s + seg.resp_bytes * self.nic_byte_s


CX6 = ServiceModel()
# CX-3-era fabric: slower wire, ~56 Gb/s, weaker RNIC read engine — the
# paper's Fig. 10 ablation where one-sided schemes are capped harder.
CX3 = ServiceModel(wire_s=1.5e-6, nic_byte_s=1 / 7e9, nic_verb_s=140e-9)
