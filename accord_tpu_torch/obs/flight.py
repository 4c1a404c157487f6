"""Black-box flight recorder: per-node bounded rings + anomaly post-mortems.

The r09 obs subsystem measures the system (registry, spans, devprof) but
nothing WATCHES the measurements: an in-sim anomaly — a coordination that
needed the watchdog, a device quarantine deepening, a protocol phase taking
8x its own distribution — leaves at most a counter increment, and by the
time anyone reads the counters the causal context (what launched, what
routed where, which faults fired just before) is gone.  This module is the
airplane-style black box:

- **Per-node ring buffers**: every span completion, deps route decision,
  fault-ladder transition, fused-dispatch launch and drain-tick sweep is
  appended (SIM-time stamped) to the node's bounded ring; old entries are
  overwritten, so the ring always holds the most recent window of causal
  history at near-zero cost (one deque.append of a small tuple).
- **Anomaly triggers** dump a POST-MORTEM BUNDLE the instant they fire:

  * ``watchdog_recover`` — a coordinated txn wedged long enough that the
    client watchdog had to adopt recovery (local.node's 15s watchdog);
  * ``quarantine_escalation`` — a store re-quarantined while already
    backed off (the fault ladder deepening, not just a one-off fault);
  * ``phase_outlier`` — a phase span's duration landed ≥ ``2^margin`` x
    the phase's own observed maximum after the rolling log2 histogram has
    ``min_samples`` observations (the spans themselves feed that
    histogram, so the detector needs no second distribution).

- **Post-mortem bundle**: the triggering node's ring contents + the
  metrics-registry snapshot DIFF since the previous dump (or arm) + the
  per-store device gauges (route/fault/launch/byte counters) — everything
  a human needs to reconstruct the seconds before the anomaly, captured
  at the anomaly, not at end of run.

Determinism contract (extends the burn matrix): every field is a pure
function of the seed — sim-time stamps, scheduler-ordered appends, sorted
snapshot keys — so same-seed runs export byte-identical bundles
(``export_json``), including under the device-fault nemesis.  Wall clock
never enters (that stays devprof's job).

Cost when unarmed: every instrumentation site guards with ONE None check
(``flight is not None``); ``ACCORD_TPU_OBS=off`` sets
``Observability.flight = None`` and the recorder never exists.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Callable, Dict, List, Optional

from .metrics import MetricsRegistry

# anomaly kinds a bundle can carry (the trigger matrix tests enumerate these)
TRIGGERS = ("watchdog_recover", "quarantine_escalation", "phase_outlier")


class FlightRecorder:
    """One run's flight recorder: per-node rings + the post-mortem store.

    ``clock`` is the SIM clock (micros); ``metrics`` the run's registry
    (snapshot-diffed into every bundle).  ``capacity`` bounds EACH node's
    ring; ``max_dumps`` bounds the post-mortem store (later triggers count
    ``suppressed`` instead of growing the export without bound)."""

    def __init__(self, clock: Callable[[], int],
                 metrics: Optional[MetricsRegistry] = None,
                 capacity: int = 512, max_dumps: int = 8,
                 min_samples: int = 64, outlier_margin: int = 2):
        self.clock = clock
        self.metrics = metrics
        self.capacity = capacity
        self.max_dumps = max_dumps
        self.min_samples = min_samples
        self.outlier_margin = outlier_margin
        self._rings: Dict[object, deque] = {}
        self.postmortems: List[dict] = []
        self.suppressed = 0              # triggers past max_dumps
        self.n_recorded = 0
        self._quar: Dict[object, int] = {}   # (node, store) -> quarantines
        # bundles diff the registry against the previous dump (or arm)
        self._base = metrics.snapshot() if metrics is not None else {}
        # () -> {"node/store": {gauge: value}} — the sim cluster wires the
        # live per-store DeviceState counters; sorted at dump time
        self.gauge_source: Optional[Callable[[], Dict[str, dict]]] = None

    # -- ring appends (the hot-path sites; each one small and sim-pure) ----
    def _ring(self, node) -> deque:
        r = self._rings.get(node)
        if r is None:
            r = self._rings[node] = deque(maxlen=self.capacity)
        return r

    def record(self, node, kind: str, **fields) -> None:
        ev = {"t": self.clock(), "kind": kind}
        ev.update(fields)
        self._ring(node).append(ev)
        self.n_recorded += 1

    def on_span(self, node, phase: str, txn: str, dur: int) -> None:
        """A phase span completed (SpanRecorder.end/end_txn tap, called
        BEFORE the duration lands in the phase histogram so the outlier
        check compares against the distribution-so-far)."""
        self.record(node, "span", phase=phase, txn=txn, dur=dur)
        if self.metrics is None:
            return
        h = self.metrics.histogram("phase_micros", phase=phase)
        # vmax must be nonzero: a phase whose whole distribution is 0µs
        # (completes within one event-loop step) would otherwise "outlier"
        # on every 1µs span and burn max_dumps on noise
        if h.count >= self.min_samples and h.vmax and \
                int(dur) > (h.vmax << self.outlier_margin):
            self.trigger(node, "phase_outlier", phase=phase, txn=txn,
                         dur=int(dur), prior_max=h.vmax, prior_n=h.count)

    def on_txn_event(self, node, txn: str, name: str) -> None:
        """A point event on a txn root (SpanRecorder.event tap)."""
        self.record(node, "event", txn=txn, name=name)
        if name == "watchdog_recover":
            self.trigger(node, "watchdog_recover", txn=txn)

    def on_route(self, node, store, route: str, nq: int) -> None:
        self.record(node, "route", store=store, route=route, nq=nq)

    def on_fault(self, node, store, event: str, detail: str = "") -> None:
        """A fault-ladder transition (the cluster's fault_observer tap).
        A ``quarantine`` while the store already quarantined this run is
        the ladder DEEPENING — the escalation trigger."""
        self.record(node, "fault", store=store, event=event, detail=detail)
        if event == "quarantine":
            key = (node, store)
            n = self._quar.get(key, 0) + 1
            self._quar[key] = n
            if n >= 2:
                self.trigger(node, "quarantine_escalation", store=store,
                             quarantines=n, detail=detail)

    def on_fused(self, node, kind: str, members: int, nq: int) -> None:
        self.record(node, "fused", fkind=kind, members=members, nq=nq)

    def on_drain(self, node, store, mode: str, frontier: int) -> None:
        """One drain-tick sweep (mode device/fused/host, frontier size) —
        the drain-regime forensics leg."""
        self.record(node, "drain", store=store, mode=mode,
                    frontier=frontier)

    # -- post-mortems ------------------------------------------------------
    def trigger(self, node, reason: str, **attrs) -> Optional[dict]:
        """Dump one post-mortem bundle (or count it suppressed past
        ``max_dumps``).  The bundle captures the triggering node's ring,
        the registry delta since the last dump, and the live per-store
        device gauges — all sim-pure, all sorted."""
        if len(self.postmortems) >= self.max_dumps:
            self.suppressed += 1
            return None
        bundle = {"seq": len(self.postmortems), "t": self.clock(),
                  "trigger": reason, "node": node, "attrs": attrs,
                  "ring": list(self._ring(node))}
        if self.metrics is not None:
            bundle["metrics_delta"] = self.metrics.diff(self._base)
            self._base = self.metrics.snapshot()
        if self.gauge_source is not None:
            gauges = self.gauge_source()
            bundle["device_gauges"] = {k: gauges[k] for k in sorted(gauges)}
        self.postmortems.append(bundle)
        return bundle

    # -- export ------------------------------------------------------------
    def export(self) -> dict:
        return {"postmortems": self.postmortems,
                "suppressed": self.suppressed,
                "recorded": self.n_recorded}

    def export_json(self) -> str:
        """Canonical bytes (sorted keys, no whitespace variance) — the
        same-seed double-run gate compares this string directly, like
        SpanRecorder.export_json."""
        return json.dumps(self.export(), sort_keys=True,
                          separators=(",", ":"))

    def __len__(self) -> int:
        return len(self.postmortems)
