"""Span records for the telemetry plane.

A :class:`Span` is one node of the op-trace taxonomy documented in
docs/OBSERVABILITY.md.  Spans are *op-clock* structured: their ``clock``
field is the hub's monotonically increasing count of submitted op lanes,
never wall time.  Layers annotate the active span as a call descends the
stack (Pipeline → Meter → CNCache → Retry → ReplicaSet → Transport), so
one flush span accumulates queue-wait, grouping, cache, retry, replica
and wire facts for its batch.

Span kinds (the taxonomy):

``flush``    one pipeline flush group (an op kind's coalesced lanes);
             ``trigger`` ∈ {window, hazard, explicit} says why it fired.
``direct``   a non-coalesced batch executed immediately at submit().
``scalar``   a v1 sync convenience call (get/insert/update/delete).

Annotation rules: numeric values **accumulate** (+=) so multiple layers
and multiple replicas can each add their share; string values overwrite.
This keeps annotation order-insensitive for the numeric facts that
multiple layers contribute to.
"""

from __future__ import annotations

SPAN_KINDS = ("flush", "direct", "scalar")


class Span:
    """One traced unit of work (a flush group, direct batch, or scalar op).

    Attributes: ``span_id`` (hub-issued, dense), ``kind`` (see
    ``SPAN_KINDS``), ``op`` (protocol op kind), ``n`` (lanes), ``clock``
    (op-clock at open), ``trigger`` (flush cause), ``ann`` (accumulated
    annotations).
    """

    __slots__ = ("span_id", "kind", "op", "n", "clock", "trigger", "ann")

    def __init__(self, span_id: int, kind: str, op: str, n: int,
                 clock: int, trigger: str = "") -> None:
        self.span_id = span_id
        self.kind = kind
        self.op = op
        self.n = n
        self.clock = clock
        self.trigger = trigger
        self.ann: dict[str, object] = {}

    def annotate(self, **kv) -> None:
        """Attach facts: numeric values accumulate, strings overwrite."""
        ann = self.ann
        for k, v in kv.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                ann[k] = v
            else:
                prev = ann.get(k)
                if isinstance(prev, (int, float)) and not isinstance(prev, bool):
                    ann[k] = prev + v
                else:
                    ann[k] = v

    def to_json_dict(self) -> dict:
        """Serialise for the ``outback-telemetry/v1`` span rows."""
        return {"span_id": self.span_id, "kind": self.kind, "op": self.op,
                "n": self.n, "clock": self.clock, "trigger": self.trigger,
                "ann": {k: self.ann[k] for k in sorted(self.ann)}}

    def __repr__(self) -> str:
        return (f"Span(#{self.span_id} {self.kind}/{self.op} n={self.n} "
                f"clock={self.clock} trigger={self.trigger!r} "
                f"ann={len(self.ann)})")


__all__ = ["SPAN_KINDS", "Span"]
