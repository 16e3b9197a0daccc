"""Round-trip / bytes / compute accounting for the RDMA-proxy evaluation.

The port of ``repro.core.meter``: plain host Python ints, because the meter
counts protocol events, not device work.  ``snapshot()`` gives the same
fields in the same order as the reference, so the two packages' totals can
be compared byte for byte.  Counters cover per-operation round trips,
on-wire bytes (64-byte padded messages, as in the paper's methodology
§5.1), and the split of compute between the compute node and the memory
node.  Every ``add`` call is also forwarded to each attached event sink.
"""

from __future__ import annotations

import dataclasses

MSG_BYTES = 64  # every RPC message padded to two cache lines (paper §5.1)


@dataclasses.dataclass
class CommMeter:
    ops: int = 0
    round_trips: int = 0
    req_bytes: int = 0
    resp_bytes: int = 0
    # memory-node side (the scarce resource in disaggregated memory)
    mn_hash_ops: int = 0
    mn_cmp_ops: int = 0  # fingerprint + key comparisons
    mn_mem_reads: int = 0  # dependent memory accesses (index + heap)
    mn_mem_writes: int = 0
    # compute-node side (abundant)
    cn_hash_ops: int = 0
    cn_cmp_ops: int = 0
    # CN-cache attribution (repro.core.cn_cache): ops answered locally and
    # the round trips / on-wire bytes those local answers saved
    cache_hits: int = 0
    cache_neg_hits: int = 0
    # pipeline write-combining (repro.api.pipeline): reads of a pending
    # write answered from the CN's write buffer — like a cache hit, the op
    # happened and the kind's wire costs land in the saved_* counters
    wc_hits: int = 0
    # serving front door (repro.serve.frontdoor): concurrent identical
    # Gets collapsed onto one upstream lane (singleflight) — the follower
    # lanes' wire costs land in the saved_* counters below, exactly like
    # cache and write-combining hits, so savings stay comparable
    sf_hits: int = 0
    saved_round_trips: int = 0
    saved_req_bytes: int = 0
    saved_resp_bytes: int = 0
    # failure-plane attribution (repro.net.faults / repro.api.replication):
    # all stay 0 on the no-fault path, so snapshots/merges remain
    # byte-identical for stores built without a FaultSchedule
    retries: int = 0         # lanes re-issued after a BACKOFF answer
    backoffs: int = 0        # lanes that received a BACKOFF answer
    drops: int = 0           # lanes lost on the wire before MN application
    failovers: int = 0       # CN-driven primary switches
    lease_renewals: int = 0  # MN lease grants/renewals (1 small RT each)
    resyncs: int = 0         # full MN-state re-installs after a restart
    fault_wait_us: int = 0   # CN stall from timeouts/backoff/lease drains
    fenced_writes: int = 0   # write lanes rejected at the MN boundary
    #                          because the issuing CN held a stale-epoch
    #                          lease (post-partition fencing; never acked)
    # Optional event sinks — an explicit per-instance field, NOT a counter:
    # every object here receives each ``add`` call (``on_meter_add``), in
    # attachment order.  Excluded from ``merge``/``reset``/``per_op``/
    # ``snapshot`` (see ``_counters``) so accounting identity is untouched
    # by observers.
    sinks: list = dataclasses.field(default_factory=list, repr=False,
                                    compare=False)

    def _counters(self):
        return [f.name for f in dataclasses.fields(self)
                if f.name != "sinks"]

    @property
    def sink(self):
        """The primary event sink (first of ``sinks``), or ``None``.

        Backward-compatible single-slot view: ``meter.sink = transport``
        still works exactly as before (it *replaces* the whole fan-out
        list with that one sink — engines assign it at construction, on
        a fresh meter).  Use :meth:`add_sink` to fan out to additional
        observers without disturbing the transport."""
        return self.sinks[0] if self.sinks else None

    @sink.setter
    def sink(self, value) -> None:
        self.sinks = [] if value is None else [value]

    def add_sink(self, sink) -> None:
        """Append an additional event sink (idempotent per object)."""
        if sink is not None and all(s is not sink for s in self.sinks):
            self.sinks.append(sink)

    def add(self, n: int = 1, *, rts: int = 0, req: int = 0, resp: int = 0,
            mn_hash: int = 0, mn_cmp: int = 0, mn_reads: int = 0,
            mn_writes: int = 0, cn_hash: int = 0, cn_cmp: int = 0,
            one_sided: bool = False, cont: bool = False,
            attach: bool = False) -> None:
        """Account ``n`` operations with the given *per-op* costs.

        ``attach=True`` (with ``n=0``) charges the costs once to the op
        already counted — an extra round trip, probe, or compare on the
        same logical op — without opening a new one; a plain ``n<=0``
        (e.g. a dynamically-computed lane count that came up empty) adds
        nothing.  Two-sided RPC messages are padded to ``MSG_BYTES`` in
        *both* directions (paper §5.1); ``one_sided=True`` is the escape
        hatch for RDMA READ traffic, whose request/response are NIC-level
        payloads, not RPC messages — their bytes accumulate raw.
        ``cont=True`` marks a dependent continuation of the previous op
        (the Makeup-Get second trip) for the transport sink; the
        accounting itself is unchanged by it.
        """
        if n <= 0 and not attach:
            return
        m = n if n > 0 else 1
        if one_sided:
            req_b, resp_b = req, resp
        else:
            pad = MSG_BYTES if rts else 0
            req_b, resp_b = max(req, pad), max(resp, pad)
        self.ops += n
        self.round_trips += m * rts
        self.req_bytes += m * req_b
        self.resp_bytes += m * resp_b
        self.mn_hash_ops += m * mn_hash
        self.mn_cmp_ops += m * mn_cmp
        self.mn_mem_reads += m * mn_reads
        self.mn_mem_writes += m * mn_writes
        self.cn_hash_ops += m * cn_hash
        self.cn_cmp_ops += m * cn_cmp
        for s in self.sinks:
            s.on_meter_add(
                n, rts=rts, req=req_b, resp=resp_b, mn_hash=mn_hash,
                mn_cmp=mn_cmp, mn_reads=mn_reads, mn_writes=mn_writes,
                cn_hash=cn_hash, cn_cmp=cn_cmp, one_sided=one_sided,
                cont=cont, attach=attach)

    def add_cache_hit(self, n: int = 1, *, neg: bool = False,
                      saved_rts: int = 1, saved_req: int = MSG_BYTES,
                      saved_resp: int = 0) -> None:
        """Account ``n`` Gets answered from the CN cache: the op happened,
        no message crossed the wire, and the listed costs were *saved*."""
        self.ops += n
        if neg:
            self.cache_neg_hits += n
        else:
            self.cache_hits += n
        self.saved_round_trips += n * saved_rts
        self.saved_req_bytes += n * saved_req
        self.saved_resp_bytes += n * saved_resp

    def add_wc_hit(self, n: int = 1, *, saved_rts: int = 1,
                   saved_req: int = MSG_BYTES, saved_resp: int = 0) -> None:
        """Account ``n`` reads served from the pipeline's write-combining
        buffer: the op happened locally; the listed wire costs were saved."""
        self.ops += n
        self.wc_hits += n
        self.saved_round_trips += n * saved_rts
        self.saved_req_bytes += n * saved_req
        self.saved_resp_bytes += n * saved_resp

    def add_sf_hit(self, n: int = 1, *, saved_rts: int = 1,
                   saved_req: int = MSG_BYTES, saved_resp: int = 0) -> None:
        """Account ``n`` singleflight-collapsed Gets: each shared a
        concurrent identical Get's upstream lane, so the op happened and
        the listed wire costs were saved (``repro.serve.frontdoor``)."""
        self.ops += n
        self.sf_hits += n
        self.saved_round_trips += n * saved_rts
        self.saved_req_bytes += n * saved_req
        self.saved_resp_bytes += n * saved_resp

    def merge(self, other: "CommMeter") -> None:
        for name in self._counters():
            setattr(self, name, getattr(self, name) + getattr(other, name))

    def per_op(self) -> dict[str, float]:
        n = max(1, self.ops)
        return {name: getattr(self, name) / n for name in self._counters()
                if name != "ops"}

    def reset(self) -> None:
        """Zero every counter; the sink (if any) stays attached."""
        for name in self._counters():
            setattr(self, name, 0)

    def snapshot(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in self._counters()}
