"""Causal per-transaction phase tracing, stamped in SIM time.

Every coordinated transaction carries a span tree over its protocol
phases::

    txn (root, one per coordinated TxnId)
    ├─ preaccept      (PreAccept round; end attrs: oks, path=fast|slow)
    ├─ accept         (slow path only: the Accept consensus round)
    ├─ stable         (Commit/Stable distribution quorum)
    ├─ read           (the read round; replica-side deps-wait nests here
    ├─ deps_wait       as sibling spans labeled node/store — the drain gate)
    └─ apply          (Apply distribution until majority-durable)

plus point EVENTS on the root: ``deps_route`` (the deps route each store
served this txn's scans from), ``recover`` (recovery hops), ``retry``
(fence-Rejected client retries), fault/quarantine markers.

All stamps come from the recorder's clock — the simulated queue clock in
sim/burn/maelstrom — so a same-seed run exports a byte-identical trace
(``export_json`` sorts keys; span order is creation order, which IS the
deterministic scheduler order).  Span durations feed the registry's
``phase_micros{phase=}`` histograms, and the fast/slow decision feeds
``txn_path{path=}`` — the fast-path rate, the headline protocol KPI.

Bounded like utils.trace.Trace: past ``capacity`` spans new work is
dropped (counted), never an error — a handle may be None and every
operation accepts that."""

from __future__ import annotations

import itertools
import json
from typing import Callable, Dict, List, Optional

from .metrics import MetricsRegistry


class Span:
    __slots__ = ("seq", "key", "name", "node", "start", "end", "attrs",
                 "events", "children")

    def __init__(self, seq: int, key: str, name: str, node, start: int):
        self.seq = seq
        self.key = key
        self.name = name
        self.node = node
        self.start = start
        self.end: Optional[int] = None
        self.attrs: Dict[str, object] = {}
        self.events: List[dict] = []
        self.children: List["Span"] = []

    def render(self) -> dict:
        out = {"seq": self.seq, "txn": self.key, "name": self.name,
               "node": self.node, "start": self.start, "end": self.end}
        if self.end is not None:
            out["dur"] = self.end - self.start
        if self.attrs:
            out["attrs"] = self.attrs
        if self.events:
            out["events"] = self.events
        if self.children:
            out["children"] = [c.render() for c in self.children]
        return out


class SpanRecorder:
    """One run's span store.  ``clock`` is the sim clock (micros)."""

    def __init__(self, clock: Callable[[], int],
                 metrics: Optional[MetricsRegistry] = None,
                 capacity: int = 200_000):
        self.clock = clock
        self.metrics = metrics
        # flight-recorder tap (obs.flight): completions and txn events
        # mirror into the black box's per-node rings; None = unarmed
        self.flight = None
        self.capacity = capacity
        self._seq = itertools.count()
        self.roots: Dict[str, Span] = {}
        self._order: List[Span] = []     # roots in creation order
        self.n_spans = 0
        self.n_events = 0                # point events share the same cap
        self.dropped = 0

    # -- recording -----------------------------------------------------------
    def _root(self, key: str, node=None) -> Optional[Span]:
        root = self.roots.get(key)
        if root is None:
            if self.n_spans >= self.capacity:
                self.dropped += 1
                return None
            root = Span(next(self._seq), key, "txn", node, self.clock())
            self.roots[key] = root
            self._order.append(root)
            self.n_spans += 1
        return root

    def begin_txn(self, key: str, node=None, **attrs) -> Optional[Span]:
        root = self._root(key, node)
        if root is not None and attrs:
            root.attrs.update(attrs)
        return root

    def end_txn(self, key: str, outcome: str = "ok") -> None:
        root = self.roots.get(key)
        if root is not None and root.end is None:
            root.end = self.clock()
            root.attrs["outcome"] = outcome
            if self.flight is not None:
                # before the observe below: the outlier check compares
                # against the distribution-so-far
                self.flight.on_span(root.node, "txn", key,
                                    root.end - root.start)
            if self.metrics is not None:
                self.metrics.histogram("phase_micros", phase="txn").observe(
                    root.end - root.start)

    def begin(self, key: str, phase: str, node=None,
              **attrs) -> Optional[Span]:
        """Open a phase span under the txn's root (creating a synthetic
        root for phases first seen via recovery on another node).  Returns
        the handle the FSM holds; every later call accepts None."""
        root = self._root(key, node)
        if root is None:
            return None
        if self.n_spans >= self.capacity:
            self.dropped += 1
            return None
        sp = Span(next(self._seq), key, phase, node, self.clock())
        if attrs:
            sp.attrs.update(attrs)
        root.children.append(sp)
        self.n_spans += 1
        return sp

    def end(self, span: Optional[Span], **attrs) -> None:
        if span is None or span.end is not None:
            return
        span.end = self.clock()
        if attrs:
            span.attrs.update(attrs)
        if self.flight is not None:
            self.flight.on_span(span.node, span.name, span.key,
                                span.end - span.start)
        if self.metrics is not None:
            self.metrics.histogram("phase_micros", phase=span.name).observe(
                span.end - span.start)

    def event(self, key: str, name: str, **attrs) -> None:
        """Point event on a txn's root — dropped (not created) for txn
        keys never coordinated here, so store-level instrumentation
        (deps routes under bench harnesses) can fire unconditionally."""
        root = self.roots.get(key)
        if root is None:
            return
        if self.n_events >= self.capacity:    # events are bounded too
            self.dropped += 1
            return
        ev = {"t": self.clock(), "name": name}
        if attrs:
            ev.update(attrs)
        root.events.append(ev)
        self.n_events += 1
        if self.flight is not None:
            self.flight.on_txn_event(root.node, key, name)

    def decision(self, key: str, path: str) -> None:
        """The fast/slow decision (ref: CoordinateTransaction.java:71-101)
        — recorded on the span tree AND as the fast-path-rate metric."""
        root = self.roots.get(key)
        if root is not None:
            root.attrs["path"] = path
        if self.metrics is not None:
            self.metrics.counter("txn_path", path=path).inc()

    # -- export --------------------------------------------------------------
    def export(self) -> List[dict]:
        """Root span trees in creation (= deterministic scheduler) order;
        open spans export with ``end: null`` — a crashed coordinator's
        trace is part of the record, not an error."""
        return [r.render() for r in self._order]

    def export_json(self) -> str:
        """Canonical bytes: sorted keys, no whitespace variance — the
        double-run determinism gate compares this string directly."""
        return json.dumps(
            {"spans": self.export(), "dropped": self.dropped},
            sort_keys=True, separators=(",", ":"))

    def fast_path_rate(self) -> Optional[float]:
        if self.metrics is None:
            return None
        fast = self.metrics.peek_counter("txn_path", path="fast")
        slow = self.metrics.peek_counter("txn_path", path="slow")
        total = fast + slow
        return (fast / total) if total else None

    def __len__(self) -> int:
        return self.n_spans
