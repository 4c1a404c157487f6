"""Per-node admission control: shed explicitly instead of collapsing.

An open-loop client population does not slow down when the server does —
offered load beyond saturation turns into queues, queues into timeouts,
timeouts into retry storms, and goodput collapses toward zero while every
admitted request waits behind work that will time out anyway.  The gate in
front of ``Node.coordinate`` keeps the server on the good side of that
cliff (ISSUE r12 tentpole layer 2; the r07 device ladder is the template:
degrade loudly, never die):

- **Bounded in-flight budget** — at most ``max_inflight`` coordinations in
  flight per node; arrivals beyond it are REJECTED immediately with an
  explicit ``Overloaded`` wire error (Maelstrom code 11,
  temporarily-unavailable) carrying a ``retry_after_ms`` hint, so a shed
  costs one JSON reply, not a coordination.
- **Latency-aware AIMD controller** — the gate observes every admitted
  txn's completion latency (the txn ROOT SPAN duration: the observation
  window is admission -> client reply, the same boundaries the r09 span
  tree stamps for ``txn``, measured here directly so the controller also
  works under ``ACCORD_TPU_OBS=off``).  When the sliding-window p99
  exceeds ``target_p99_micros`` the dynamic budget shrinks
  multiplicatively; while p99 sits comfortably below target it recovers
  additively — classic AIMD, converging to the deepest pipeline the
  latency target allows.
- **Degradation-ladder composition** — ``device_health`` (wired by the
  server to the r07 quarantine state of the node's stores) scales the
  budget DOWN while any store is quarantined or OOM-degraded: a sick
  device lowers admission instead of letting queues grow behind the
  slower host fallback.

The gate is transport-agnostic plain Python (no asyncio): the serving
process calls it from its single event-loop thread, tests drive it with a
fake clock.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional, Tuple


class Overloaded(RuntimeError):
    """Explicit admission rejection — the client-side sink surfaces this
    (instead of a generic failure) so callers retry with backoff rather
    than treating it as an indeterminate op."""

    def __init__(self, msg: str = "overloaded",
                 retry_after_ms: int = 100, reason: str = "inflight"):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms
        self.reason = reason


class SpanPhaseP99:
    """Windowed per-phase p99 from the r09 span trees (ROADMAP item 4's
    second open remainder): the coordinate FSMs already stamp every phase
    into ``phase_micros{phase=}`` histograms — this reader diffs those
    bucket counts between admission-controller adjust points and returns
    the worst per-phase p99 of the DELTA, so the controller sees the same
    sliding-window shape its own root measurement gave it, but sourced
    from the span instrumentation (and able to flag a single ballooning
    phase, e.g. a replica-side ``deps_wait``, before the root mean moves).

    Returns None when the spans are disabled (``ACCORD_TPU_OBS=off``) or
    the window holds too few samples — the gate then falls back to its
    own root-span measurement, exactly the r12 behaviour."""

    MIN_SAMPLES = 8

    def __init__(self, metrics, name: str = "phase_micros"):
        self.metrics = metrics
        self.name = name
        self._prev: Dict[Tuple, Dict[int, int]] = {}

    def read(self) -> Optional[int]:
        from ..obs.metrics import Histogram
        worst = None
        for (n, labels), h in sorted(self.metrics._m.items()):
            if n != self.name or not hasattr(h, "buckets"):
                continue
            prev = self._prev.get(labels, {})
            delta = {b: c - prev.get(b, 0) for b, c in h.buckets.items()
                     if c - prev.get(b, 0) > 0}
            self._prev[labels] = dict(h.buckets)
            count = sum(delta.values())
            if count < self.MIN_SAMPLES:
                continue
            # reuse the registry histogram's percentile (its min/max
            # clamp keeps the log2 bucket's up-to-2x upper-bound bias
            # out of the controller: a steady true p99 just over a
            # power of two must not read as nearly double the target)
            w = Histogram()
            w.buckets = delta
            w.count = count
            w.vmin, w.vmax = h.vmin, h.vmax
            p99 = w.percentile(0.99)
            if p99 is not None and (worst is None or p99 > worst):
                worst = p99
        return worst


class AdmissionGate:
    """Bounded in-flight budget + sliding-p99 AIMD controller.

    ``try_admit`` / ``release`` bracket one coordination; ``release`` feeds
    the completion latency into the sliding window the controller reads.
    All state is plain ints/floats — the hot-path cost of an admit is two
    comparisons and an increment.

    When ``phase_p99`` is wired (a :class:`SpanPhaseP99` reader over the
    obs registry), the controller's latency signal comes from the span
    trees' per-phase histograms instead; the root-span sliding window is
    kept as the fallback so the gate still works under
    ``ACCORD_TPU_OBS=off``.
    """

    # controller shape: recompute every ADJUST_EVERY completions; cut the
    # budget by CUT on p99-over-target, recover by +1 while p99 is below
    # RECOVER_FRACTION of target (the hysteresis band keeps the budget from
    # oscillating around the target)
    ADJUST_EVERY = 32
    CUT = 0.7
    RECOVER_FRACTION = 0.75

    def __init__(self, max_inflight: int = 64,
                 target_p99_micros: int = 1_000_000,
                 min_budget: int = 4,
                 window: int = 512,
                 device_health: Optional[Callable[[], float]] = None,
                 metrics=None,
                 phase_p99: Optional[Callable[[], Optional[int]]] = None):
        self.max_inflight = max_inflight
        self.target_p99_micros = target_p99_micros
        self.min_budget = min(min_budget, max_inflight)
        self.device_health = device_health
        self.metrics = metrics
        self.phase_p99 = phase_p99
        self.inflight = 0
        self.dyn_budget = float(max_inflight)
        self._lat = deque(maxlen=window)
        self._since_adjust = 0
        self._p99: Optional[int] = None
        self._p99_source = "root"
        # counters (also mirrored into the metrics registry when wired)
        self.n_admitted = 0
        self.n_released = 0
        self.n_shed: Dict[str, int] = {}
        self.n_latency_cuts = 0

    # -- read-outs -----------------------------------------------------------
    def sliding_p99(self) -> Optional[int]:
        """p99 over the completion window (recomputed lazily at adjust
        points; this forces a fresh read)."""
        if not self._lat:
            return None
        xs = sorted(self._lat)
        return xs[min(len(xs) - 1, (len(xs) * 99) // 100)]

    def health(self) -> float:
        if self.device_health is None:
            return 1.0
        h = self.device_health()
        return min(1.0, max(0.0, h))

    def effective_budget(self) -> int:
        return max(self.min_budget, int(self.dyn_budget * self.health()))

    # -- admit / release ------------------------------------------------------
    def try_admit(self) -> Tuple[bool, Optional[str], int]:
        """(admitted, shed_reason, retry_after_ms).  Reasons name the
        binding constraint: ``inflight`` (the hard budget), ``latency``
        (the AIMD controller has cut the dynamic budget), ``quarantine``
        (the device ladder has scaled it down)."""
        budget = self.effective_budget()
        if self.inflight < budget:
            self.inflight += 1
            self.n_admitted += 1
            if self.metrics is not None:
                self.metrics.counter("admission_admitted").inc()
            return True, None, 0
        if self.health() < 1.0 and self.inflight < max(
                self.min_budget, int(self.dyn_budget)):
            reason = "quarantine"
        elif self.dyn_budget < self.max_inflight:
            reason = "latency"
        else:
            reason = "inflight"
        self.n_shed[reason] = self.n_shed.get(reason, 0) + 1
        if self.metrics is not None:
            self.metrics.counter("admission_shed", reason=reason).inc()
        # retry hint: roughly one current p99 (the time for a budget slot
        # to drain), floored so shed storms don't retry in lockstep-zero
        p99 = self._p99
        retry_ms = max(25, min(2000, (p99 or 100_000) // 1000))
        return False, reason, retry_ms

    def unadmit(self) -> None:
        """Reverse one ``try_admit()`` whose slot was never used (the
        fast-shed peek lost a race to a release): hand the slot back and
        back the admitted count out, so the slow path's authoritative
        ``try_admit`` doesn't double-count the op in admitted/released."""
        self.inflight = max(0, self.inflight - 1)
        self.n_admitted -= 1
        if self.metrics is not None:
            self.metrics.counter("admission_admitted").inc(-1)

    def release(self, duration_micros: Optional[int], ok: bool = True) -> None:
        """One admitted coordination completed.  A COORDINATED failure
        (timeout, recovery loss) still feeds the controller — timeouts ARE
        the latency signal overload produces.  ``duration_micros=None``
        frees the slot WITHOUT teaching the controller: the instant
        synchronous error paths (malformed op, handler exception) complete
        in microseconds, and feeding those near-zero samples would let
        poison traffic argue the node is fast while real coordinations
        are drowning."""
        self.inflight = max(0, self.inflight - 1)
        self.n_released += 1
        if duration_micros is None:
            return
        self._lat.append(int(duration_micros))
        self._since_adjust += 1
        if self._since_adjust >= self.ADJUST_EVERY:
            self._since_adjust = 0
            self._adjust()

    def _adjust(self) -> None:
        p99 = None
        self._p99_source = "root"
        if self.phase_p99 is not None:
            # span-tree feed (ROADMAP item 4 remainder): worst per-phase
            # p99 of the window between adjust points; None (obs off /
            # too few samples) falls through to the root measurement
            p99 = self.phase_p99()
            if p99 is not None:
                self._p99_source = "spans"
        if p99 is None:
            p99 = self.sliding_p99()
        self._p99 = p99
        if p99 is None:
            return
        if p99 > self.target_p99_micros:
            self.dyn_budget = max(float(self.min_budget),
                                  self.dyn_budget * self.CUT)
            self.n_latency_cuts += 1
            if self.metrics is not None:
                self.metrics.counter("admission_latency_cuts").inc()
        elif p99 < self.target_p99_micros * self.RECOVER_FRACTION:
            self.dyn_budget = min(float(self.max_inflight),
                                  self.dyn_budget + 1.0)

    # -- export ---------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "inflight": self.inflight,
            "budget": self.effective_budget(),
            "dyn_budget": round(self.dyn_budget, 2),
            "health": round(self.health(), 3),
            "admitted": self.n_admitted,
            "released": self.n_released,
            "shed": dict(sorted(self.n_shed.items())),
            "shed_total": sum(self.n_shed.values()),
            "latency_cuts": self.n_latency_cuts,
            "sliding_p99_micros": self._p99,
            "p99_source": self._p99_source,
        }


def rebalance_health_of(node) -> float:
    """Admission factor while a reconfiguration rebalance is in flight
    (r17, elastic serving): a store bootstrapping newly-adopted ranges is
    doing snapshot installs + fence coordination on the same single
    thread that serves traffic, so the budget takes a PRICED cut scaled
    to how much of the node's ownership is still migrating — the load
    spike of a join/leave is absorbed as explicit sheds at a reduced
    depth, never as a queue collapse.  Floored at 0.5: a rebalance slows
    admission, it never starves it."""
    stores = getattr(getattr(node, "command_stores", None), "stores", None)
    if not stores:
        return 1.0
    try:
        # fast path — the steady state: nothing migrating, no arithmetic
        # (this runs on every admission check, including the per-frame
        # fast-shed peek)
        if all(s.bootstrapping.is_empty() for s in stores):
            return 1.0
    except Exception:
        return 1.0
    owned = boot = 0
    for store in stores:
        try:
            for r in store.ranges_for_epoch.current():
                owned += r.end - r.start
            for r in store.bootstrapping:
                boot += r.end - r.start
        except Exception:
            continue
    if not boot or not owned:
        return 1.0
    return max(0.5, 1.0 - 0.5 * min(1.0, boot / owned))


def device_health_of(node) -> float:
    """Fraction of the node's command stores whose device routes are
    healthy (not quarantined, not OOM-degraded) — the r07 ladder read the
    admission gate composes with.  Stores without a device (host mode)
    count healthy: the ladder has nothing to say about them."""
    stores = getattr(getattr(node, "command_stores", None), "stores", None)
    if not stores:
        return 1.0
    healthy = total = 0
    for store in stores:
        total += 1
        dev = getattr(store, "device", None)
        if dev is None or (not dev.host_pinned
                           and dev._dev_quar_flushes <= 0):
            healthy += 1
    return healthy / total if total else 1.0
