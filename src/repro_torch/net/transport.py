"""The transport seam: records every ``CommMeter`` event as a replayable op.

The port of ``repro.net.transport``: host Python, the same dataclasses and
the same meter-to-trace rules, so one op stream gives the same trace in
both packages.  A :class:`Transport` plugs into ``CommMeter.sink`` (see
``repro_torch.core.meter`` — every KVS constructor in
``repro_torch.core`` accepts ``transport=`` and wires it there).  From
then on the meter forwards each ``add`` call verbatim: the *accounting* stays byte-for-byte what the meter
reports, and the transport turns the same stream into a trace of
:class:`OpEvent` descriptors — per-op round-trip segments carrying on-wire
bytes and the MN/CN work counters.  The trace holds raw *counters*, not
times: one recorded workload can be replayed under any
:class:`repro_torch.net.service.ServiceModel` / client count / doorbell
setting via :func:`repro_torch.net.replay.simulate`.

Meter-to-trace rules (mirroring how the KVS protocols call ``add``):

* ``add(n>0, rts=r, ...)`` opens ``n`` new ops, each with ``r`` segments
  (bytes split evenly across segments; MN work attached to the first —
  only one-sided multi-RT ops ever have ``r > 1`` today, and those carry
  no MN CPU work at all).
* ``add(0, ...)`` attaches extra cost to the op it belongs to: extra
  round trips become extra segments, pure compute lands on the op /
  its last segment.
* ``add(..., cont=True)`` (the Makeup-Get path) appends the round trip to
  a *previous* op instead of opening a new one.  Attachment walks
  backwards through the most recent batch so each mismatched lane's
  makeup lands on a distinct op — exactly one extra RT per affected op,
  matching §4.3.1.
* ``mark_resize(n_live)`` drops a marker the replay engine turns into an
  MN-CPU slowdown window of ``n_live * rebuild_per_key_s`` work (§4.4).

Failure-plane annotations (the reference's ``repro.net.faults``): segments
carry the replica they were served by (``Segment.mn``, stamped from
``Transport.current_mn`` — the replication adapter sets it around each
replica call) and any CN-side stall accrued before posting
(``Segment.wait_s``, accumulated via :meth:`Transport.add_wait` by the
delay/backoff/lease paths).  ``mark_fault`` drops a :class:`FaultMark`
the replay engine turns into a paused-replica or NIC-saturation window.
All three default to inert values, so a store without faults or
replication produces byte-identical traces to earlier revisions.  The
port's callers are ``repro_torch.api.replication.ReplicaSetAdapter``
(``mark_fault``, ``add_wait``, ``current_mn``) and
``repro_torch.api.stack.RetryLayer`` (``add_wait``); ``cn_dst`` stays
inert until the cluster plane is ported.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Segment:
    """One round trip: request out, MN service, response back."""

    req_bytes: int
    resp_bytes: int
    one_sided: bool = False
    verbs: int = 1
    mn_hash: int = 0
    mn_cmp: int = 0
    mn_reads: int = 0
    mn_writes: int = 0
    mn: int = 0          # serving replica (replay routes by this index)
    wait_s: float = 0.0  # CN-side stall (delay/backoff/lease) before posting
    cn_dst: int = -1     # >= 0: CN->CN RPC served by that compute node's
    #                      RPC thread instead of an MN (cluster forwarding)

    def with_mn(self, *, mn_hash=0, mn_cmp=0, mn_reads=0, mn_writes=0):
        return dataclasses.replace(
            self, mn_hash=self.mn_hash + mn_hash, mn_cmp=self.mn_cmp + mn_cmp,
            mn_reads=self.mn_reads + mn_reads,
            mn_writes=self.mn_writes + mn_writes)


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One client operation: CN compute, then its segments in sequence."""

    segments: tuple[Segment, ...]
    cn_hash: int = 0
    cn_cmp: int = 0


@dataclasses.dataclass(frozen=True)
class ResizeMark:
    """A §4.4 table split began here: ``n_live`` keys must be rebuilt."""

    n_live: int


@dataclasses.dataclass(frozen=True)
class FaultMark:
    """A host-plane fault window opened here (``repro_torch.net.faults``).

    ``kind`` is ``"mn_crash"`` (pause replica ``mn``'s CPU+NIC servers
    for ``down_s`` of sim time), ``"nic_saturation"`` (stretch that
    replica's NIC service by ``factor`` for ``down_s``),
    ``"partition"`` (cut the ``cn`` <-> replica ``mn`` link for
    ``down_s``; ``mn=-1`` cuts every link from ``cn``), or ``"fenced"``
    (instant: a stale-lease write was rejected at the MN boundary).
    Replays that predate the failure plane simply skip these marks."""

    kind: str
    mn: int = 0
    down_s: float = 0.0
    factor: float = 1.0
    cn: int = -1   # CN endpoint for partition/fenced marks; -1 = n/a


@dataclasses.dataclass(frozen=True)
class DoorbellMark:
    """A pipeline flush rang the doorbell here: the next ``n_ops`` ops
    were posted under one coalesced window (``repro_torch.api.pipeline``).
    ``replay.simulate(window="policy")`` uses these to set each client's
    outstanding-ops window to what the store's ``BatchPolicy`` actually
    produced; numeric-window replays skip them."""

    n_ops: int


class Transport:
    """CommMeter sink: builds the op trace the simulator replays.

    One transport may be shared by several meters (an ``OutbackStore``
    attaches its own meter and every shard's); events interleave in host
    execution order, which is what a single compute node observes.
    """

    def __init__(self) -> None:
        self.trace: list[OpEvent | ResizeMark] = []
        # index of the op the next cont/attachment event belongs to; walks
        # backwards through the latest batch so per-lane makeups spread out
        self._attach = -1
        self._cont_used = False
        # failure-plane state: replica stamped into new segments, and a
        # pending CN-side wait consumed by the next op opened (both stay
        # at their inert defaults unless a ReplicaSetAdapter drives them)
        self.current_mn = 0
        self._pending_wait_s = 0.0
        # cluster plane: >= 0 while recording a CN->CN forward RPC — the
        # destination CN's index is stamped into new segments (Segment.cn_dst)
        self.current_cn_dst = -1

    # ------------------------------------------------------- sink protocol
    def on_meter_add(self, n: int, *, rts: int, req: int, resp: int,
                     mn_hash: int, mn_cmp: int, mn_reads: int, mn_writes: int,
                     cn_hash: int, cn_cmp: int, one_sided: bool,
                     cont: bool, attach: bool = False) -> None:
        """Forwarded by ``CommMeter.add`` with the *accounted* per-op bytes
        (request/response padding already applied).  The meter filters out
        empty non-attach events, so ``n == 0`` here always means attach."""
        if cont and n > 0:
            # A fresh makeup continuation: step to the next-older op so each
            # mismatched lane of a batch gets exactly one extra round trip.
            if self._cont_used:
                self._attach -= 1
            self._cont_used = True
        if cont or attach or n == 0:
            self._attach_to_previous(rts, req, resp, mn_hash, mn_cmp,
                                     mn_reads, mn_writes, cn_hash, cn_cmp,
                                     one_sided)
            return
        segments = self._make_segments(rts, req, resp, mn_hash, mn_cmp,
                                       mn_reads, mn_writes, one_sided)
        ev = OpEvent(segments=segments, cn_hash=cn_hash, cn_cmp=cn_cmp)
        self.trace.extend([ev] * n)  # shared object; copy-on-attach below
        self._attach = len(self.trace) - 1
        self._cont_used = False

    def mark_resize(self, n_live: int) -> None:
        self.trace.append(ResizeMark(int(n_live)))
        self._attach = -1
        self._cont_used = False

    def mark_fault(self, kind: str, *, mn: int = 0, down_s: float = 0.0,
                   factor: float = 1.0, cn: int = -1) -> None:
        """Drop a :class:`FaultMark` at the current trace position.

        Like :meth:`begin_doorbell` this does **not** move the
        attachment cursor: fault windows open *around* ops and must not
        break Makeup-Get continuation attachment."""
        self.trace.append(FaultMark(kind, mn=mn, down_s=down_s,
                                    factor=factor, cn=cn))

    def add_wait(self, seconds: float) -> None:
        """Accrue a CN-side stall charged to the next op recorded.

        The delay/backoff/lease paths call this before re-issuing or
        proceeding; the pending wait lands on the first segment of the
        next op (or attachment) so the replay engine stalls that op's
        posting by the same amount."""
        if seconds > 0:
            self._pending_wait_s += seconds

    def begin_doorbell(self) -> int:
        """Open a doorbell window (a pipeline flush boundary) whose op
        count is not yet known — lanes a CN cache absorbs never reach the
        trace; returns a token for :meth:`close_doorbell`.  The
        placeholder mark stays in place (so attachment indices never
        shift) and is patched to the *recorded* op count at close.
        Unlike ``mark_resize`` this does not move the attachment cursor:
        the flush's ops follow immediately and makeup continuations must
        still walk back through the previous batch unimpeded."""
        token = len(self.trace)
        self.trace.append(DoorbellMark(0))
        return token

    def close_doorbell(self, token: int) -> None:
        n = sum(1 for e in self.trace[token + 1:] if isinstance(e, OpEvent))
        self.trace[token] = DoorbellMark(n)

    # --------------------------------------------------------------- util
    def _make_segments(self, rts, req, resp, mn_hash, mn_cmp, mn_reads,
                       mn_writes, one_sided) -> tuple[Segment, ...]:
        if rts <= 0:
            return ()
        wait, self._pending_wait_s = self._pending_wait_s, 0.0
        segs = []
        for i in range(rts):
            seg = Segment(req_bytes=req // rts + (req % rts if i == 0 else 0),
                          resp_bytes=resp // rts + (resp % rts if i == 0 else 0),
                          one_sided=one_sided, mn=self.current_mn,
                          wait_s=wait if i == 0 else 0.0,
                          cn_dst=self.current_cn_dst)
            if i == 0:
                seg = seg.with_mn(mn_hash=mn_hash, mn_cmp=mn_cmp,
                                  mn_reads=mn_reads, mn_writes=mn_writes)
            segs.append(seg)
        return tuple(segs)

    def _attach_to_previous(self, rts, req, resp, mn_hash, mn_cmp, mn_reads,
                            mn_writes, cn_hash, cn_cmp, one_sided) -> None:
        """Fold an attachment (``n==0``) or a Makeup-Get continuation
        (``cont=True``) into the op at the attachment cursor."""
        i = self._attach
        while i >= 0 and isinstance(self.trace[i],
                                    (ResizeMark, DoorbellMark, FaultMark)):
            i -= 1
        self._attach = i
        if i < 0:  # nothing to attach to: record as a standalone op
            if rts > 0:
                self.trace.append(OpEvent(
                    segments=self._make_segments(rts, req, resp, mn_hash,
                                                 mn_cmp, mn_reads, mn_writes,
                                                 one_sided),
                    cn_hash=cn_hash, cn_cmp=cn_cmp))
                self._attach = len(self.trace) - 1
            return
        op = self.trace[i]
        if rts > 0:
            extra = self._make_segments(rts, req, resp, mn_hash, mn_cmp,
                                        mn_reads, mn_writes, one_sided)
            op = dataclasses.replace(op, segments=op.segments + extra,
                                     cn_hash=op.cn_hash + cn_hash,
                                     cn_cmp=op.cn_cmp + cn_cmp)
        elif op.segments:  # pure compute: fold into the op's last segment
            segs = list(op.segments)
            segs[-1] = segs[-1].with_mn(mn_hash=mn_hash, mn_cmp=mn_cmp,
                                        mn_reads=mn_reads,
                                        mn_writes=mn_writes)
            op = dataclasses.replace(op, segments=tuple(segs),
                                     cn_hash=op.cn_hash + cn_hash,
                                     cn_cmp=op.cn_cmp + cn_cmp)
        else:
            op = dataclasses.replace(op, cn_hash=op.cn_hash + cn_hash,
                                     cn_cmp=op.cn_cmp + cn_cmp)
        self.trace[i] = op  # copy-on-attach: batch siblings stay shared

    # ---------------------------------------------------------------- api
    def __len__(self) -> int:
        return sum(1 for e in self.trace if isinstance(e, OpEvent))

    def event_counts(self) -> dict[str, int]:
        """Per-kind tally of the trace (ops/segments + each mark kind).

        A cheap deterministic summary for telemetry exports: counting
        never touches the trace, so it is safe under the dormant-plane
        contract."""
        ops = segs = resize = fault = doorbell = 0
        for e in self.trace:
            if isinstance(e, OpEvent):
                ops += 1
                segs += len(e.segments)
            elif isinstance(e, ResizeMark):
                resize += 1
            elif isinstance(e, FaultMark):
                fault += 1
            elif isinstance(e, DoorbellMark):
                doorbell += 1
        return {"ops": ops, "segments": segs, "resize_marks": resize,
                "fault_marks": fault, "doorbell_marks": doorbell}

    def reset(self) -> None:
        self.trace.clear()
        self._attach = -1
        self._cont_used = False
        self.current_mn = 0
        self._pending_wait_s = 0.0
        self.current_cn_dst = -1
