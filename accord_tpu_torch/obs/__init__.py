"""Unified observability: metrics registry, causal phase tracing, device
profiling.

Three PRs of perf/robustness work (r06-r08) each invented their own counter
plumbing — route counters on the bench ``# index:`` line, ``Cluster.stats``
dicts, burn stats, DeviceState attribute counters — and nothing recorded
latency distributions or the fast-path rate at all.  This package is the
single layer they all migrate onto:

- :mod:`accord_tpu.obs.metrics` — named counters / gauges / log-bucketed
  histograms with label sets, deterministic iteration, snapshot/diff.  The
  sim cluster's stats dict is a byte-compatible view over one registry.
- :mod:`accord_tpu.obs.spans` — per-transaction span trees over the
  protocol phases (PreAccept -> fast/slow decision -> Accept ->
  Commit/Stable -> deps-wait -> read -> Apply), stamped in SIM time so
  same-seed runs export byte-identical traces.
- :mod:`accord_tpu.obs.devprof` — wall-clock profiler around every device
  launch boundary (upload / kernel / harvest; fused vs solo) with a
  Chrome-trace (``chrome://tracing``) exporter.
- :mod:`accord_tpu.obs.flight` — the black-box flight recorder: per-node
  bounded event rings (spans, routes, fault-ladder transitions, fused
  launches, drain sweeps) whose anomaly triggers (watchdog recovery,
  quarantine escalation, phase-latency outlier) dump deterministic
  post-mortem bundles the instant they fire.

Knob: ``ACCORD_TPU_OBS=off`` disables span recording, histogram
observation and the device profiler (mirroring ``ACCORD_TPU_FUSION=off``;
the conftest canary asserts the knob is honored and tier-1 stays green
under it — observability is never load-bearing for correctness).  The
metrics registry itself stays on: it IS the store behind the sim's
protocol stats, which the verification gates read.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from .flight import FlightRecorder
from .metrics import MetricsRegistry
from .spans import SpanRecorder


def enabled() -> bool:
    """The ACCORD_TPU_OBS escape hatch: default ON; "off"/"0"/"false"/"no"
    disables spans, histograms and the device profiler."""
    return os.environ.get("ACCORD_TPU_OBS", "").lower() not in (
        "off", "0", "false", "no")


class Observability:
    """One run's observability bundle: a metrics registry (always live —
    it backs the sim's protocol stats) and a span recorder (None when the
    subsystem is disabled).  ``now`` is the SIM clock so every stamp is a
    pure function of the seed."""

    def __init__(self, now: Optional[Callable[[], int]] = None,
                 spans_on: Optional[bool] = None):
        self.metrics = MetricsRegistry()
        on = enabled() if spans_on is None else spans_on
        self.spans: Optional[SpanRecorder] = (
            SpanRecorder(now or (lambda: 0), self.metrics) if on else None)
        # the black-box flight recorder stands down with the spans (the
        # ACCORD_TPU_OBS=off escape hatch is total); when live it taps the
        # span recorder so phase completions and txn events need no second
        # instrumentation site
        self.flight: Optional[FlightRecorder] = (
            FlightRecorder(now or (lambda: 0), self.metrics) if on else None)
        if self.spans is not None:
            self.spans.flight = self.flight


def spans_of(node) -> Optional[SpanRecorder]:
    """The span recorder attached to a protocol node, or None — the one
    guard every coordinate/* instrumentation site uses (cost when
    unobserved: one getattr + one None check)."""
    o = getattr(node, "obs", None)
    return o.spans if o is not None else None
