"""Closed-loop replay of a recorded op trace through the event simulator.

The port of ``repro.net.replay``: host Python and numpy, every
floating-point expression in the reference's order, so the same trace
gives equal (not merely close) results in both packages.

``simulate(trace, clients=C, window=W, ...)`` models ``C`` compute-node
clients, each owning one RC queue pair with at most ``W`` outstanding
operations (the bounded-outstanding-verbs window).  Clients pull ops from
the shared trace in order; each op runs its round-trip segments in
sequence:

  CN compute -> post (per-QP server, doorbell-coalesced) -> wire ->
  MN NIC (shared) -> MN CPU (shared, ``mn_threads`` workers; skipped for
  one-sided verbs) -> wire -> CN completion.

Everything is deterministic: the event heap breaks time ties by insertion
order and no randomness exists anywhere, so the same trace produces
bit-identical latency percentiles on every run.

A :class:`repro_torch.net.transport.ResizeMark` in the trace opens a rebuild
window: the MN CPU's service times stretch by ``resize_slow_factor`` for
the simulated duration of rebuilding ``n_live`` keys (§4.4's
CPU-share-during-resize effect), and the window is reported so callers can
plot the throughput dip timeline.

Failure plane (the reference's ``repro.net.faults``):
``simulate(..., replicas=K)``
instantiates K independent MN replica servers (CPU + NIC each) and routes
every segment by its recorded ``Segment.mn``.  A
:class:`repro_torch.net.transport.FaultMark` pauses a crashed replica's servers
for ``down_s`` (queued work survives and drains at restart) or stretches
its NIC service by ``factor`` (saturation window); ``Segment.wait_s``
stalls that op's posting — the CN-side cost of timeouts, jittered
backoff, and lease drains decided on the host plane.  A
``FaultMark(kind="partition")`` cuts a CN<->replica *link* (``mn=-1``:
every link from that CN): segments posted over a cut link hold at the CN
until the link heals, per link — not per MN, so unpartitioned CNs keep
full service from the same replica.  ``kind="fenced"`` marks are
instants (a rejected stale-lease write), reported as zero-length
windows.  All fault windows are reported in
:attr:`SimResult.fault_windows` and :meth:`SimResult.availability` turns
the completion timeline into the bench suite's availability curve.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.net.service import CX6, ServiceModel
from repro_torch.net.sim import Server, Simulator
from repro_torch.net.transport import (DoorbellMark, FaultMark, OpEvent,
                                 ResizeMark)


@dataclasses.dataclass
class SimResult:
    n_ops: int
    seconds: float              # makespan (first post to last completion)
    latencies_us: np.ndarray    # per-op, in completion order
    completions_s: np.ndarray   # completion timestamps, same order
    resize_windows: list[tuple[float, float]]
    mn_cpu_busy_s: float
    mn_nic_busy_s: float
    # (t0, t1, kind, replica) for every FaultMark window that opened
    fault_windows: list[tuple[float, float, str, int]] = \
        dataclasses.field(default_factory=list)
    # populated only under simulate(record_spans=True):
    # op_spans: per-op dicts {cid, t0_s, t1_s, cn_hash, cn_cmp, segs:
    #   [{t0_s, t1_s, mn, one_sided, wait_s}, ...]} in completion order;
    # server_spans: (start_s, service_s, server_name) per started batch;
    # doorbell_ts: (sim_time_s, n_ops) per consumed DoorbellMark
    op_spans: list[dict] = dataclasses.field(default_factory=list)
    server_spans: list[tuple[float, float, str]] = \
        dataclasses.field(default_factory=list)
    doorbell_ts: list[tuple[float, int]] = \
        dataclasses.field(default_factory=list)
    # populated only by simulate_open: per-op latency / completion time
    # indexed by *trace-op order* (not completion order), so open-loop
    # callers can join each offered request back to its upstream lane
    lat_by_op_us: np.ndarray = \
        dataclasses.field(default_factory=lambda: np.empty(0, np.float64))
    completions_by_op_s: np.ndarray = \
        dataclasses.field(default_factory=lambda: np.empty(0, np.float64))

    @property
    def tput_mops(self) -> float:
        return self.n_ops / max(self.seconds, 1e-12) / 1e6

    def percentile_us(self, q: float) -> float:
        return float(np.percentile(self.latencies_us, q))

    def percentiles(self) -> dict[str, float]:
        p = self.latencies_us
        return {"p50_us": float(np.percentile(p, 50)),
                "p90_us": float(np.percentile(p, 90)),
                "p99_us": float(np.percentile(p, 99)),
                "p999_us": float(np.percentile(p, 99.9)),
                "mean_us": float(p.mean()),
                "max_us": float(p.max())}

    def tput_in_window(self, t0: float, t1: float) -> float:
        """Completed-ops throughput (Mops) inside a sim-time window."""
        if t1 <= t0:
            return 0.0
        n = int(((self.completions_s >= t0) & (self.completions_s < t1)).sum())
        return n / (t1 - t0) / 1e6

    def tput_timeline(self, n_buckets: int = 40) -> tuple[np.ndarray,
                                                          np.ndarray]:
        """Bucketed completed-ops throughput over the makespan.

        Returns ``(bucket_start_s, tput_mops)`` arrays of length
        ``n_buckets`` — the raw series behind the availability curve.
        """
        n_buckets = max(1, int(n_buckets))
        span = max(self.seconds, 1e-12)
        edges = np.linspace(0.0, span, n_buckets + 1)
        counts, _ = np.histogram(self.completions_s, bins=edges)
        widths = np.diff(edges)
        return edges[:-1], counts / np.maximum(widths, 1e-12) / 1e6

    def availability(self, n_buckets: int = 40) -> dict:
        """The bench suite's availability curve, as a versioned JSON dict.

        Availability per bucket = bucket throughput normalised by the
        *median* bucket throughput (robust to the dip itself), clipped
        to [0, 1].  The dict schema (``outback-availability/v1``) is
        what CI's faults-smoke lane validates.
        """
        t, mops = self.tput_timeline(n_buckets)
        base = float(np.median(mops))
        avail = np.clip(mops / base, 0.0, 1.0) if base > 0 \
            else np.zeros_like(mops)
        return {"schema": "outback-availability/v1",
                "bucket_s": float(self.seconds / max(1, int(n_buckets))),
                "t_s": [float(x) for x in t],
                "tput_mops": [float(x) for x in mops],
                "availability": [float(x) for x in avail],
                "fault_windows": [[float(a), float(b), k, int(r)]
                                  for a, b, k, r in self.fault_windows]}


def simulate(trace, *, clients: int = 1, window: int | str = 1,
             mn_threads: int = 1, doorbell: bool = True,
             service: ServiceModel = CX6,
             max_ops: int | None = None, replicas: int = 1,
             record_spans: bool = False) -> SimResult:
    """Replay ``trace`` with ``clients`` closed-loop clients.

    ``window`` bounds each client QP's outstanding ops (>=1); posting more
    than one WQE back-to-back is where doorbell batching pays off.  Pass
    ``window="policy"`` to take the window from the trace's recorded
    :class:`repro_torch.net.transport.DoorbellMark` boundaries instead: each
    pipeline flush of ``n`` ops replays with an ``n``-deep window (ops
    recorded before any mark replay synchronously), so the simulated
    latency/throughput reflects the store's ``BatchPolicy`` rather than a
    sweep parameter.  ``replicas=K`` gives each MN replica its own CPU
    (``mn_threads`` workers) and NIC servers, with segments routed by
    their recorded ``Segment.mn``; ``FaultMark`` crash windows pause the
    marked replica's servers and NIC-saturation windows stretch its NIC
    service.  There is no randomness anywhere: the same trace and
    parameters produce bit-identical percentiles on every run.

    ``record_spans=True`` additionally captures per-op spans (client id,
    post/complete times, per-segment wire intervals), per-server busy
    intervals, and doorbell instants into the result — the raw material
    for the reference's ``repro.obs.export.chrome_trace``.  Recording is pure
    observation: schedules, latencies and percentiles are bit-identical
    with it on or off.
    """
    policy_window = window == "policy"
    # "left" counts the current doorbell group down so ops recorded
    # *outside* any flush (scalar conveniences, pre-pipeline traffic)
    # revert to a synchronous window instead of inheriting the last mark
    cur_w = {"w": 1 if policy_window else max(1, int(window)), "left": 0}
    sim = Simulator()
    n_rep = max(1, int(replicas))
    mn_cpus = [Server(sim, workers=max(1, mn_threads), name=f"mn_cpu{r}")
               for r in range(n_rep)]
    mn_nics = [Server(sim, workers=1, name=f"mn_nic{r}")
               for r in range(n_rep)]
    items = list(trace)
    if max_ops is not None:
        kept, n = [], 0
        for it in items:
            if isinstance(it, OpEvent):
                if n >= max_ops:
                    continue
                n += 1
            kept.append(it)
        items = kept

    cursor = {"i": 0}
    slow_open = {"n": 0}  # rebuild windows currently stealing CPU share
    crash_open = [0] * n_rep       # nested crash windows per replica
    sat_open: list[list[float]] = [[] for _ in range(n_rep)]
    link_heal = [0.0] * n_rep      # sim time the link to replica r heals
    lat_us: list[float] = []
    done_t: list[float] = []
    windows: list[tuple[float, float]] = []
    fwindows: list[tuple[float, float, str, int]] = []
    op_spans: list[dict] = []
    server_spans: list[tuple[float, float, str]] = []
    doorbell_ts: list[tuple[float, int]] = []
    if record_spans:
        for srv in mn_cpus + mn_nics:
            srv.log = server_spans

    def _open_fault_window(mark: FaultMark) -> None:
        t0 = sim.now
        if mark.kind == "fenced":  # an instant, not a window
            fwindows.append((t0, t0, "fenced", max(mark.cn, 0)))
            return
        if mark.kind == "partition":  # mn=-1 cuts every link
            rs = range(n_rep) if mark.mn < 0 else [mark.mn % n_rep]
            for r in rs:
                link_heal[r] = max(link_heal[r], t0 + mark.down_s)
            fwindows.append((t0, t0 + mark.down_s, "partition",
                             max(mark.cn, 0)))
            return
        r = mark.mn % n_rep
        fwindows.append((t0, t0 + mark.down_s, mark.kind, r))
        if mark.kind == "mn_crash":
            crash_open[r] += 1
            mn_cpus[r].pause()
            mn_nics[r].pause()

            def restart():
                crash_open[r] -= 1
                if crash_open[r] == 0:
                    # restart drains the RNIC backlog FCFS
                    mn_nics[r].resume()
                    mn_cpus[r].resume()

            sim.schedule(mark.down_s, restart)
        elif mark.kind == "nic_saturation":
            sat_open[r].append(mark.factor)
            mn_nics[r].factor = max(sat_open[r])

            def clear():
                sat_open[r].remove(mark.factor)
                mn_nics[r].factor = max(sat_open[r]) if sat_open[r] else 1.0

            sim.schedule(mark.down_s, clear)
        # other kinds (delay/drop) are host-plane only: their cost is
        # already in Segment.wait_s / retried segments

    def next_item():
        while cursor["i"] < len(items):
            it = items[cursor["i"]]
            cursor["i"] += 1
            if isinstance(it, ResizeMark):
                _open_resize_window(sim, mn_cpus, it, service, windows,
                                    slow_open)
                continue
            if isinstance(it, FaultMark):
                _open_fault_window(it)
                continue
            if isinstance(it, DoorbellMark):
                if record_spans:
                    doorbell_ts.append((sim.now, it.n_ops))
                if policy_window:  # numeric windows ignore recorded flushes
                    cur_w["w"] = max(1, it.n_ops)
                    cur_w["left"] = it.n_ops
                continue
            if policy_window:
                if cur_w["left"] <= 0:
                    cur_w["w"] = 1  # op outside any doorbell group
                else:
                    cur_w["left"] -= 1
            return it
        return None

    class Client:
        __slots__ = ("post", "inflight", "cid")

        def __init__(self, cid: int) -> None:
            # one RC QP per client: posts serialise here, and queued WQEs
            # coalesce under one doorbell when batching is on
            self.post = Server(
                sim, workers=1,
                coalesce=service.max_doorbell if doorbell else 1,
                coalesce_extra_s=service.cn_post_batched_s,
                name=f"qp{cid}")
            self.inflight = 0
            self.cid = cid

        def pump(self) -> None:
            while self.inflight < cur_w["w"]:
                op = next_item()
                if op is None:
                    return
                self.inflight += 1
                t0 = sim.now
                rec = None
                if record_spans:
                    rec = {"cid": self.cid, "t0_s": t0, "t1_s": 0.0,
                           "cn_hash": op.cn_hash, "cn_cmp": op.cn_cmp,
                           "segs": []}
                sim.schedule(service.cn_compute_s(op.cn_hash, op.cn_cmp),
                             lambda op=op, t0=t0, rec=rec:
                             self._segment(op, 0, t0, rec))

        def _segment(self, op: OpEvent, si: int, t0: float,
                     rec: dict | None = None) -> None:
            if rec is not None and rec["segs"]:
                rec["segs"][-1]["t1_s"] = sim.now  # previous segment done
            if si >= len(op.segments):
                lat_us.append((sim.now - t0) * 1e6)
                done_t.append(sim.now)
                if rec is not None:
                    rec["t1_s"] = sim.now
                    op_spans.append(rec)
                self.inflight -= 1
                self.pump()
                return
            seg = op.segments[si]
            r = seg.mn % n_rep
            if rec is not None:
                rec["segs"].append({"t0_s": sim.now, "t1_s": sim.now,
                                    "mn": r, "one_sided": seg.one_sided,
                                    "wait_s": seg.wait_s})

            def after_post():
                sim.schedule(service.wire_s, arrive_mn)

            def arrive_mn():
                mn_nics[r].request(service.mn_nic_s(seg), after_nic)

            def after_nic():
                if seg.one_sided:
                    respond()
                else:
                    mn_cpus[r].request(service.mn_cpu_s(seg), respond)

            def respond():
                sim.schedule(service.wire_s + service.cn_recv_s(seg),
                             lambda: self._segment(op, si + 1, t0, rec))

            def start_post():
                self.post.request(service.cn_post_s, after_post)

            # host-plane stall (backoff/lease/delay) plus any partition
            # hold: a segment posted over a cut link waits for the heal
            stall = seg.wait_s + max(0.0, link_heal[r] - sim.now)
            if stall > 0:
                sim.schedule(stall, start_post)
            else:
                start_post()

    cs = [Client(i) for i in range(max(1, clients))]
    for c in cs:
        c.pump()
    sim.run()

    return SimResult(
        n_ops=len(lat_us), seconds=sim.now,
        latencies_us=np.asarray(lat_us, dtype=np.float64),
        completions_s=np.asarray(done_t, dtype=np.float64),
        resize_windows=windows,
        mn_cpu_busy_s=sum(s.busy_s for s in mn_cpus),
        mn_nic_busy_s=sum(s.busy_s for s in mn_nics),
        fault_windows=fwindows,
        op_spans=op_spans, server_spans=server_spans,
        doorbell_ts=doorbell_ts)


def simulate_open(trace, arrivals_s, *, mn_threads: int = 1,
                  doorbell: bool = True, service: ServiceModel = CX6,
                  replicas: int = 1, qps: int = 8) -> SimResult:
    """Replay ``trace`` **open-loop**: op ``i`` posts at the absolute sim
    time ``arrivals_s[i]`` whether or not earlier ops completed.

    The closed-loop :func:`simulate` couples offered load to completion
    rate (a client only posts when a window slot frees), so overload can
    never be expressed.  Here the arrival schedule *is* the load: the
    serving plane (the reference's ``repro.serve``) decides outcomes on
    the host path and
    hands the surviving lanes' post instants to this function
    (``FrontDoor.lane_arrivals``), and queueing delay shows up as
    latency — the raw material of the ``slo`` suite's
    goodput-vs-offered-load curves and overload p999.

    ``arrivals_s`` must have exactly one entry per ``OpEvent`` in the
    trace (``ValueError`` otherwise — the alignment contract; the CN
    cache must be off when recording, since cache hits never reach the
    trace).  Arrivals need not be sorted.  Posts from the open-loop
    client spread across ``qps`` queue pairs round-robin (op ``i`` posts
    on QP ``i % qps``), each with doorbell coalescing as in
    :func:`simulate`; recorded :class:`DoorbellMark` boundaries are
    ignored — flush windows shaped the *host* batching, while posting
    here is arrival-driven.  ``ResizeMark``/``FaultMark`` items apply at
    the arrival instant of the next op after them in the trace.
    Deterministic like everything else: the event heap breaks time ties
    by insertion order, so the same (trace, arrivals) pair produces
    bit-identical results on every run.

    The returned :class:`SimResult` additionally carries
    ``lat_by_op_us`` / ``completions_by_op_s`` indexed by trace-op order,
    so callers can join request records back to their lanes.
    """
    items = list(trace)
    ops: list[OpEvent] = []
    marks: list[tuple[int, object]] = []  # (index of next op, mark)
    for it in items:
        if isinstance(it, OpEvent):
            ops.append(it)
        elif isinstance(it, (ResizeMark, FaultMark)):
            marks.append((len(ops), it))
        # DoorbellMarks: host-plane flush shape; ignored open-loop
    arr = np.asarray(arrivals_s, dtype=np.float64)
    if arr.shape[0] != len(ops):
        raise ValueError(
            f"arrivals/trace misalignment: {arr.shape[0]} arrivals for "
            f"{len(ops)} trace OpEvents (is a CN cache answering some "
            f"lanes locally?)")
    n = len(ops)
    sim = Simulator()
    n_rep = max(1, int(replicas))
    mn_cpus = [Server(sim, workers=max(1, mn_threads), name=f"mn_cpu{r}")
               for r in range(n_rep)]
    mn_nics = [Server(sim, workers=1, name=f"mn_nic{r}")
               for r in range(n_rep)]
    qpool = [Server(sim, workers=1,
                    coalesce=service.max_doorbell if doorbell else 1,
                    coalesce_extra_s=service.cn_post_batched_s,
                    name=f"qp{q}")
             for q in range(max(1, int(qps)))]

    slow_open = {"n": 0}
    crash_open = [0] * n_rep
    sat_open: list[list[float]] = [[] for _ in range(n_rep)]
    link_heal = [0.0] * n_rep
    lat_us: list[float] = []
    done_t: list[float] = []
    lat_by_op = np.full(n, np.nan, dtype=np.float64)
    done_by_op = np.full(n, np.nan, dtype=np.float64)
    windows: list[tuple[float, float]] = []
    fwindows: list[tuple[float, float, str, int]] = []

    def _open_fault_window(mark: FaultMark) -> None:
        t0 = sim.now
        if mark.kind == "fenced":
            fwindows.append((t0, t0, "fenced", max(mark.cn, 0)))
            return
        if mark.kind == "partition":
            rs = range(n_rep) if mark.mn < 0 else [mark.mn % n_rep]
            for r in rs:
                link_heal[r] = max(link_heal[r], t0 + mark.down_s)
            fwindows.append((t0, t0 + mark.down_s, "partition",
                             max(mark.cn, 0)))
            return
        r = mark.mn % n_rep
        fwindows.append((t0, t0 + mark.down_s, mark.kind, r))
        if mark.kind == "mn_crash":
            crash_open[r] += 1
            mn_cpus[r].pause()
            mn_nics[r].pause()

            def restart():
                crash_open[r] -= 1
                if crash_open[r] == 0:
                    mn_nics[r].resume()
                    mn_cpus[r].resume()

            sim.schedule(mark.down_s, restart)
        elif mark.kind == "nic_saturation":
            sat_open[r].append(mark.factor)
            mn_nics[r].factor = max(sat_open[r])

            def clear():
                sat_open[r].remove(mark.factor)
                mn_nics[r].factor = max(sat_open[r]) if sat_open[r] else 1.0

            sim.schedule(mark.down_s, clear)

    def _segment(op: OpEvent, oi: int, si: int, t0: float) -> None:
        if si >= len(op.segments):
            lat = (sim.now - t0) * 1e6
            lat_us.append(lat)
            done_t.append(sim.now)
            lat_by_op[oi] = lat
            done_by_op[oi] = sim.now
            return
        seg = op.segments[si]
        r = seg.mn % n_rep
        post = qpool[oi % len(qpool)]

        def after_post():
            sim.schedule(service.wire_s, arrive_mn)

        def arrive_mn():
            mn_nics[r].request(service.mn_nic_s(seg), after_nic)

        def after_nic():
            if seg.one_sided:
                respond()
            else:
                mn_cpus[r].request(service.mn_cpu_s(seg), respond)

        def respond():
            sim.schedule(service.wire_s + service.cn_recv_s(seg),
                         lambda: _segment(op, oi, si + 1, t0))

        def start_post():
            post.request(service.cn_post_s, after_post)

        stall = seg.wait_s + max(0.0, link_heal[r] - sim.now)
        if stall > 0:
            sim.schedule(stall, start_post)
        else:
            start_post()

    def _launch(op: OpEvent, oi: int) -> None:
        t0 = sim.now
        sim.schedule(service.cn_compute_s(op.cn_hash, op.cn_cmp),
                     lambda: _segment(op, oi, 0, t0))

    # everything is scheduled up front at t=0, so sim.schedule's relative
    # delays ARE the absolute instants; ties (several arrivals at the
    # same time, marks at an op's arrival) break by insertion order —
    # marks first, then ops in trace order
    for mi, mark in marks:
        at = float(arr[mi]) if mi < n else (float(arr[-1]) if n else 0.0)
        if isinstance(mark, ResizeMark):
            sim.schedule(at, lambda m=mark: _open_resize_window(
                sim, mn_cpus, m, service, windows, slow_open))
        else:
            sim.schedule(at, lambda m=mark: _open_fault_window(m))
    for oi, op in enumerate(ops):
        sim.schedule(float(arr[oi]), lambda op=op, oi=oi: _launch(op, oi))
    sim.run()

    return SimResult(
        n_ops=len(lat_us), seconds=sim.now,
        latencies_us=np.asarray(lat_us, dtype=np.float64),
        completions_s=np.asarray(done_t, dtype=np.float64),
        resize_windows=windows,
        mn_cpu_busy_s=sum(s.busy_s for s in mn_cpus),
        mn_nic_busy_s=sum(s.busy_s for s in mn_nics),
        fault_windows=fwindows,
        lat_by_op_us=lat_by_op, completions_by_op_s=done_by_op)


def simulate_cluster(traces, *, clients_per_cn: int = 1,
                     window: int | str = 1, mn_threads: int = 1,
                     doorbell: bool = True, service: ServiceModel = CX6,
                     replicas: int = 1,
                     max_ops: int | None = None) -> SimResult:
    """Replay N per-CN traces against one shared MN pool.

    The multi-CN companion to :func:`simulate` (the reference's
    ``repro.cluster`` records
    one trace per compute node): every CN gets ``clients_per_cn``
    closed-loop clients consuming *its own* trace in order, while all CNs
    contend on the same ``replicas`` MN CPU/NIC server pairs — the
    disaggregated-memory scaling experiment, where aggregate throughput
    grows with CNs until the MN side saturates.

    Cluster-specific trace items:

    * segments with ``Segment.cn_dst >= 0`` are CN->CN forward RPCs: they
      queue on the *destination CN's* RPC thread (one worker per CN)
      instead of an MN server, costing its NIC + CPU service — so owner
      CNs serialise the forwards they absorb;
    * ``FaultMark(kind="cn_crash")`` records an availability window for
      the marked CN (``replica`` = CN id) without pausing any server —
      the dead CN's stack already answers degraded on the host plane, and
      its shards failed over;
    * ``FaultMark(kind="partition")`` cuts the link between the mark's
      ``cn`` and replica ``mn`` (``mn=-1``: every link from that CN)
      *globally*: whichever trace carries the mark, only segments posted
      by the partitioned CN to cut replicas hold until the heal — other
      CNs keep full service from the same replica (per-link semantics);
      ``kind="fenced"`` marks record zero-length windows (a rejected
      stale-lease write instant);
    * ``window="policy"`` honours each CN's own recorded DoorbellMark
      boundaries independently (per-CN pipeline flushes).

    Latencies/completions aggregate over all CNs in completion order;
    determinism is inherited from the event heap's insertion-order
    tie-break, so the same traces replay bit-identically.
    """
    policy_window = window == "policy"
    sim = Simulator()
    n_rep = max(1, int(replicas))
    mn_cpus = [Server(sim, workers=max(1, mn_threads), name=f"mn_cpu{r}")
               for r in range(n_rep)]
    mn_nics = [Server(sim, workers=1, name=f"mn_nic{r}")
               for r in range(n_rep)]
    cn_traces = [list(t) for t in traces]
    n_cns = max(1, len(cn_traces))
    cn_rpcs = [Server(sim, workers=1, name=f"cn_rpc{c}")
               for c in range(n_cns)]
    if max_ops is not None:  # per-CN cap: each trace keeps its prefix
        for c, items in enumerate(cn_traces):
            kept, n = [], 0
            for it in items:
                if isinstance(it, OpEvent):
                    if n >= max_ops:
                        continue
                    n += 1
                kept.append(it)
            cn_traces[c] = kept

    slow_open = {"n": 0}
    crash_open = [0] * n_rep
    sat_open: list[list[float]] = [[] for _ in range(n_rep)]
    link_heal: dict[tuple, float] = {}  # (cn, replica) -> link heal time
    lat_us: list[float] = []
    done_t: list[float] = []
    windows: list[tuple[float, float]] = []
    fwindows: list[tuple[float, float, str, int]] = []

    def _open_fault_window(mark: FaultMark, src_cn: int = 0) -> None:
        t0 = sim.now
        if mark.kind == "cn_crash":
            fwindows.append((t0, t0 + mark.down_s, "cn_crash", mark.mn))
            return  # host-plane failover; no sim-plane server to pause
        if mark.kind == "fenced":
            fwindows.append((t0, t0, "fenced",
                             mark.cn if mark.cn >= 0 else src_cn))
            return
        if mark.kind == "partition":
            cn = mark.cn if mark.cn >= 0 else src_cn
            rs = range(n_rep) if mark.mn < 0 else [mark.mn % n_rep]
            for r in rs:
                link_heal[(cn, r)] = max(link_heal.get((cn, r), 0.0),
                                         t0 + mark.down_s)
            fwindows.append((t0, t0 + mark.down_s, "partition", cn))
            return
        r = mark.mn % n_rep
        fwindows.append((t0, t0 + mark.down_s, mark.kind, r))
        if mark.kind == "mn_crash":
            crash_open[r] += 1
            mn_cpus[r].pause()
            mn_nics[r].pause()

            def restart():
                crash_open[r] -= 1
                if crash_open[r] == 0:
                    mn_nics[r].resume()
                    mn_cpus[r].resume()

            sim.schedule(mark.down_s, restart)
        elif mark.kind == "nic_saturation":
            sat_open[r].append(mark.factor)
            mn_nics[r].factor = max(sat_open[r])

            def clear():
                sat_open[r].remove(mark.factor)
                mn_nics[r].factor = max(sat_open[r]) if sat_open[r] else 1.0

            sim.schedule(mark.down_s, clear)

    class _CNFeed:
        """One CN's trace cursor + policy-window state."""

        __slots__ = ("items", "i", "cn", "cur_w")

        def __init__(self, items, cn: int) -> None:
            self.items = items
            self.i = 0
            self.cn = cn
            self.cur_w = {"w": 1 if policy_window else max(1, int(window)),
                          "left": 0}

        def next_item(self):
            while self.i < len(self.items):
                it = self.items[self.i]
                self.i += 1
                if isinstance(it, ResizeMark):
                    _open_resize_window(sim, mn_cpus, it, service, windows,
                                        slow_open)
                    continue
                if isinstance(it, FaultMark):
                    _open_fault_window(it, self.cn)
                    continue
                if isinstance(it, DoorbellMark):
                    if policy_window:
                        self.cur_w["w"] = max(1, it.n_ops)
                        self.cur_w["left"] = it.n_ops
                    continue
                if policy_window:
                    if self.cur_w["left"] <= 0:
                        self.cur_w["w"] = 1
                    else:
                        self.cur_w["left"] -= 1
                return it
            return None

    feeds = [_CNFeed(items, c) for c, items in enumerate(cn_traces)]

    class Client:
        __slots__ = ("post", "inflight", "feed")

        def __init__(self, cid: int, feed: _CNFeed) -> None:
            self.post = Server(
                sim, workers=1,
                coalesce=service.max_doorbell if doorbell else 1,
                coalesce_extra_s=service.cn_post_batched_s,
                name=f"qp{cid}")
            self.inflight = 0
            self.feed = feed

        def pump(self) -> None:
            while self.inflight < self.feed.cur_w["w"]:
                op = self.feed.next_item()
                if op is None:
                    return
                self.inflight += 1
                t0 = sim.now
                sim.schedule(service.cn_compute_s(op.cn_hash, op.cn_cmp),
                             lambda op=op, t0=t0: self._segment(op, 0, t0))

        def _segment(self, op: OpEvent, si: int, t0: float) -> None:
            if si >= len(op.segments):
                lat_us.append((sim.now - t0) * 1e6)
                done_t.append(sim.now)
                self.inflight -= 1
                self.pump()
                return
            seg = op.segments[si]

            def after_post():
                sim.schedule(service.wire_s, arrive)

            def arrive():
                if seg.cn_dst >= 0:
                    # CN->CN forward: the owner's RPC thread absorbs both
                    # the NIC handling and the dispatch compute
                    cn_rpcs[seg.cn_dst % n_cns].request(
                        service.mn_nic_s(seg) + service.mn_cpu_s(seg),
                        respond)
                    return
                r = seg.mn % n_rep
                mn_nics[r].request(service.mn_nic_s(seg),
                                   lambda: after_nic(r))

            def after_nic(r):
                if seg.one_sided:
                    respond()
                else:
                    mn_cpus[r].request(service.mn_cpu_s(seg), respond)

            def respond():
                sim.schedule(service.wire_s + service.cn_recv_s(seg),
                             lambda: self._segment(op, si + 1, t0))

            def start_post():
                self.post.request(service.cn_post_s, after_post)

            # partition hold: MN-bound segments over a cut link wait for
            # the heal; CN->CN forwards ride a different fabric path
            stall = seg.wait_s
            if link_heal and seg.cn_dst < 0:
                stall += max(0.0, link_heal.get(
                    (self.feed.cn, seg.mn % n_rep), 0.0) - sim.now)
            if stall > 0:
                sim.schedule(stall, start_post)
            else:
                start_post()

    cs = [Client(c * max(1, clients_per_cn) + j, feeds[c])
          for c in range(n_cns) for j in range(max(1, clients_per_cn))]
    for cl in cs:
        cl.pump()
    sim.run()

    return SimResult(
        n_ops=len(lat_us), seconds=sim.now,
        latencies_us=np.asarray(lat_us, dtype=np.float64),
        completions_s=np.asarray(done_t, dtype=np.float64),
        resize_windows=windows,
        mn_cpu_busy_s=sum(s.busy_s for s in mn_cpus),
        mn_nic_busy_s=sum(s.busy_s for s in mn_nics),
        fault_windows=fwindows)


def _open_resize_window(sim: Simulator, mn_cpus: list[Server],
                        mark: ResizeMark, service: ServiceModel,
                        windows: list[tuple[float, float]],
                        slow_open: dict) -> None:
    """Stretch MN CPU service while the rebuild's CPU share is stolen.

    Windows may overlap (back-to-back splits): the slowdown is held open
    until the *last* one closes.  With replicas the rebuild runs on every
    copy (lockstep replication re-splits each replica), so the slowdown
    applies to all replica CPUs.
    """
    work = mark.n_live * service.rebuild_per_key_s
    f = service.resize_slow_factor
    # at CPU share 1/f the rebuild's `work` CPU-seconds take f/(f-1) x work
    # of wall time, spread across the MN's worker threads
    duration = work * (f / max(f - 1.0, 1e-9)) / mn_cpus[0].workers
    t0 = sim.now
    slow_open["n"] += 1
    for cpu in mn_cpus:
        cpu.factor = f
    windows.append((t0, t0 + duration))

    def close():
        slow_open["n"] -= 1
        if slow_open["n"] == 0:
            for cpu in mn_cpus:
                cpu.factor = 1.0

    sim.schedule(duration, close)
