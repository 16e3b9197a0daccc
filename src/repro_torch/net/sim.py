"""Deterministic discrete-event engine for the RDMA transport simulator.

The port of ``repro.net.sim``, unchanged in behaviour.

Tiny on purpose: a time-ordered event heap (ties broken by insertion
sequence, so two runs over the same event trace produce *identical*
schedules — no wall clock, no RNG anywhere in the engine) plus an FCFS
multi-worker ``Server`` resource with two extras the transport needs:

* **doorbell coalescing** — when more than one request is queued at the
  moment a worker frees up, up to ``coalesce`` of them are served as one
  batch: the first pays its full service time, the rest pay only
  ``coalesce_extra_s`` each (one doorbell ring covers the whole WQE chain).
  ``coalesce=1`` disables batching (every post pays full price).
* **a slowdown factor** — service times started while ``factor > 1`` are
  stretched by it (used to model the MN CPU share lost to an index rebuild
  during a §4.4 resize window).
* **pause/resume** — a paused server stops starting new jobs (in-flight
  service still completes: the wire already carried those requests) until
  resumed; the failure plane uses this for MN crash windows
  (the reference's ``repro.net.faults``).  Queued jobs survive a pause
  and drain in FCFS
  order at resume, which is exactly a crashed-then-restarted MN whose
  RNIC backlog replays.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Callable


class Simulator:
    """Event heap with a monotone clock. ``schedule`` -> ``run``."""

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0  # insertion order breaks time ties deterministically

    def schedule(self, delay_s: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (self.now + delay_s, self._seq, fn))
        self._seq += 1

    def run(self) -> float:
        """Drain the heap; returns the final clock value (seconds)."""
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            fn()
        return self.now


class Server:
    """FCFS queue over ``workers`` identical servers.

    ``request(service_s, done)`` enqueues a job; ``done()`` fires at the
    simulated instant the job's service completes.
    """

    def __init__(self, sim: Simulator, workers: int = 1, *,
                 coalesce: int = 1, coalesce_extra_s: float = 0.0,
                 name: str = "") -> None:
        self.sim = sim
        self.workers = workers
        self.free = workers
        self.queue: deque[tuple[float, Callable[[], None]]] = deque()
        self.coalesce = max(1, coalesce)
        self.coalesce_extra_s = coalesce_extra_s
        self.factor = 1.0  # >1 while a background job steals CPU share
        self.busy_s = 0.0  # integrated service time (utilisation accounting)
        self.paused = False
        self.name = name
        # optional service log: (start_s, service_s, name) per started
        # batch, appended in schedule order (deterministic).  The replay
        # engine attaches a shared list here under record_spans=True so
        # MN busy intervals can be exported as trace slices.
        self.log: list | None = None

    def request(self, service_s: float, done: Callable[[], None]) -> None:
        self.queue.append((service_s, done))
        self._drain()

    def pause(self) -> None:
        """Stop starting new jobs (crash window); queued work is kept."""
        self.paused = True

    def resume(self) -> None:
        """Restart after a pause and drain any backlog FCFS."""
        self.paused = False
        self._drain()

    def _drain(self) -> None:
        while self.free and self.queue and not self.paused:
            self.free -= 1
            svc, done = self.queue.popleft()
            batch = [done]
            while len(batch) < self.coalesce and self.queue:
                extra_svc, extra_done = self.queue.popleft()
                svc += self.coalesce_extra_s
                batch.append(extra_done)
            svc *= self.factor
            self.busy_s += svc
            if self.log is not None:
                self.log.append((self.sim.now, svc, self.name))
            self.sim.schedule(svc, lambda batch=batch: self._complete(batch))

    def _complete(self, batch: list[Callable[[], None]]) -> None:
        self.free += 1
        for done in batch:
            done()
        self._drain()
