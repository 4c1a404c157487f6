"""Device-launch profiler: wall-clock slices around every accelerator
boundary, exported as a Chrome trace (``chrome://tracing`` /
``ui.perfetto.dev`` JSON).

The r08 launch-coalescing win was only visible as counters (launches per
1k txns); this makes it a TIMELINE: every DeviceDispatcher /
DeviceState launch boundary (upload, kernel dispatch, result harvest;
fused vs solo) emits one complete event when a profiler is armed.

Wall-clock timings are NOT deterministic, so nothing here ever touches
the metrics registry or the sim stats (the burn's determinism gates
compare those byte-for-byte).  Arming is explicit and process-global:

    from accord_tpu_torch.obs import devprof
    with devprof.capture() as prof:
        ... run the workload ...
    prof.write_chrome("trace.json")

Cost when unarmed: the hot-path guard is one module-attribute read and a
None check (``devprof.PROFILER is not None``) — the same pattern as
utils.trace.  The ``ACCORD_TPU_OBS=off`` escape hatch wins over arming:
capture() then yields an inert profiler that records nothing."""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional

# the process-global armed profiler; instrumentation sites read this once
PROFILER: Optional["DeviceProfiler"] = None


class DeviceProfiler:
    """Bounded in-memory collector of Chrome-trace complete events."""

    def __init__(self, capacity: int = 500_000):
        self.capacity = capacity
        self.events: List[dict] = []
        self.dropped = 0
        self._t0 = time.perf_counter()

    def _ts(self, t: float) -> float:
        return (t - self._t0) * 1e6        # Chrome trace wants micros

    def complete(self, name: str, t_start: float, t_end: float,
                 cat: str = "device", pid: int = 0, tid: int = 0,
                 args: Optional[dict] = None) -> None:
        """One finished slice [t_start, t_end] (perf_counter seconds)."""
        if len(self.events) >= self.capacity:
            self.dropped += 1
            return
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round(self._ts(t_start), 3),
              "dur": round((t_end - t_start) * 1e6, 3),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, cat: str = "device", pid: int = 0,
                tid: int = 0, args: Optional[dict] = None) -> None:
        if len(self.events) >= self.capacity:
            self.dropped += 1
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "p",
              "ts": round(self._ts(time.perf_counter()), 3),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    @contextlib.contextmanager
    def slice(self, name: str, cat: str = "device", pid: int = 0,
              tid: int = 0, args: Optional[dict] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, t0, time.perf_counter(), cat=cat,
                          pid=pid, tid=tid, args=args)

    # -- export --------------------------------------------------------------
    def chrome_trace(self) -> dict:
        counts: Dict[str, int] = {}
        for ev in self.events:
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
        return {"traceEvents": self.events,
                "displayTimeUnit": "ms",
                "otherData": {"producer": "accord_tpu_torch.obs.devprof",
                              "event_counts": counts,
                              "dropped": self.dropped}}

    def write_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


@contextlib.contextmanager
def capture(capacity: int = 500_000):
    """Arm a profiler for the with-body (process-global; nesting keeps the
    outer one armed again afterwards).  Under ``ACCORD_TPU_OBS=off`` the
    yielded profiler is never armed, so instrumentation stays silent and
    the trace exports empty — the escape hatch is total."""
    global PROFILER
    prof = DeviceProfiler(capacity)
    from . import enabled
    prev = PROFILER
    if enabled():
        PROFILER = prof
    try:
        yield prof
    finally:
        PROFILER = prev
