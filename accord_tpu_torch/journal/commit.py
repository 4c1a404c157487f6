"""Group commit: one fsync acknowledges every append in the batch.

The durability tax of a WAL is the fsync, not the write: appends are
page-cache stores (~µs) while an fsync is device-dependent (~50µs on a
fast NVMe, ~10ms on spinning rust, ~wild on a loaded CI box).  Syncing
per record would put that full cost on EVERY transaction; group commit
opens a short *batching window* after the first un-synced append and one
fsync at window close acknowledges the whole batch — per-txn durability
cost amortizes to fsync/batch_size, exactly the shape of the r08 fused
launches (one launch answers every member store).

The window is PRICED, never a hard threshold (the r06 router discipline):
``probe_fsync_micros`` measures this directory's actual fsync cost once
per process (median of a few 4KB write+fsync rounds) and the window is a
small multiple of it, clamped to sane bounds — a fast device flushes
almost eagerly (window ≈ its own fsync cost: batching can't win much, so
latency isn't spent chasing it), a slow device batches harder (the window
buys proportionally more amortization).

Two more priced decisions joined at r16 (a flush CYCLE has a fixed CPU
cost beyond the fsync — begin/complete bookkeeping, accounting, and the
worker-thread hop when one is wired — and on a fast device that fixed
cost, not the fsync, dominates the journal's per-txn serving tax):

- *offload only when it pays*: the fsync rides ``async_exec`` only when
  the probed fsync cost exceeds ``probe_offload_micros`` (the probed
  round-trip of handing work to a worker thread).  A tmpfs-class fsync
  (~µs) runs inline — burning a ~100µs hop to avoid a ~2µs wait was the
  single largest journal overhead at saturation — while a slow
  filesystem still keeps its multi-ms fsyncs off the event loop.
- *lazy waiter-less windows*: a window close with NO ``after_durable``
  waiter defers once to the ``LAZY_MAX_LAG_MICROS`` horizon instead of
  flushing, so records nobody gates on — protocol facts under
  ``sync=client``, everything under ``periodic`` — and parked
  latest-wins register rows (``deferred_pending``/``pre_flush``) batch
  across windows and pay one flush cycle per lag bound instead of one
  per window.  Crash-equivalent: un-fsynced records die together either
  way; a waiter arriving mid-lag gets a window-delay timer, keeping the
  normal gate-latency bound (and on the eager-gate path its flush skips
  the register drain entirely — ``flush(drain=False)`` — so gating a
  reply never forces parked rows to serialize early).

``after_durable(fn)`` is the acknowledgement edge the serving node hangs
replies on: fn runs once every record appended so far is fsynced — either
immediately (nothing pending) or at the batch's fsync.

Failed fsync is terminal for the durability PROMISE (the postgres
fsync-gate lesson: the kernel may have dropped the dirty pages, so a
retry that "succeeds" proves nothing).  Policy is the r07 ladder's:
degrade loudly, never die — the journal marks itself failed, releases
every waiter (availability over a guarantee it can no longer make),
counts it, and the owner stands journaling down.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

from .wal import WriteAheadLog

# window = clamp(WINDOW_FACTOR * probed_fsync, MIN, MAX) micros
WINDOW_FACTOR = 2.0
WINDOW_MIN_MICROS = 200
WINDOW_MAX_MICROS = 8_000

# r16: a window close with NO durability waiter defers ONCE to a lag
# horizon instead of flushing (a flush cycle has a real fixed CPU cost —
# begin/fsync/complete/account, plus the offload hop when one is wired —
# and a record nobody is waiting on only needs BOUNDED lag, not a prompt
# fsync; under sync=client the protocol records explicitly ride page
# cache anyway).  The horizon also sets how long latest-wins deferred
# facts (register rows, see ``deferred_pending``) may coalesce before
# they serialize — roughly a command's transition lifetime, so
# back-to-back status rows merge into one record.
LAZY_MAX_LAG_MICROS = 10_000

# once-per-process fsync cost per directory's filesystem (keyed on the
# device id so every journal on one mount shares the probe)
_probe_cache: Dict[int, int] = {}
_offload_probe: List[int] = []


def probe_fsync_micros(directory: str, rounds: int = 5) -> int:
    """Median write+fsync cost of a small record in ``directory``."""
    try:
        dev = os.stat(directory).st_dev
    except OSError:
        dev = -1
    cached = _probe_cache.get(dev)
    if cached is not None:
        return cached
    samples = []
    try:
        fd, path = tempfile.mkstemp(prefix=".fsync-probe-", dir=directory)
        try:
            with os.fdopen(fd, "wb") as f:
                payload = b"\x00" * 4096
                for _ in range(rounds):
                    t0 = time.perf_counter_ns()
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                    samples.append((time.perf_counter_ns() - t0) // 1_000)
        finally:
            os.unlink(path)
    except OSError:
        samples = [1_000]
    samples.sort()
    cost = max(1, samples[len(samples) // 2])
    _probe_cache[dev] = cost
    return cost


def priced_window_micros(directory: str) -> int:
    cost = probe_fsync_micros(directory)
    return max(WINDOW_MIN_MICROS,
               min(WINDOW_MAX_MICROS, int(cost * WINDOW_FACTOR)))


def probe_offload_micros(rounds: int = 64) -> int:
    """Median round-trip of handing a no-op to a worker thread — the
    fixed price of offloading ONE fsync off the event loop.  Probed once
    per process (same discipline as the fsync probe): on a tmpfs-class
    device the fsync is cheaper than the hop and offloading it BURNS
    cpu to avoid a shorter wait, while on a slow filesystem the hop is
    noise against a multi-ms fsync.  ``flush`` compares the two probes
    instead of hardcoding a device class."""
    if _offload_probe:
        return _offload_probe[0]
    import concurrent.futures
    samples = []
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ex.submit(lambda: None).result()      # thread spawn off the clock
        for _ in range(rounds):
            t0 = time.perf_counter_ns()
            ex.submit(lambda: None).result()
            samples.append((time.perf_counter_ns() - t0) // 1_000)
    samples.sort()
    cost = max(1, samples[len(samples) // 2])
    _offload_probe.append(cost)
    return cost


class GroupCommit:
    """Batching layer over one :class:`WriteAheadLog`.

    ``defer(delay_seconds, fn)`` schedules the window-close flush (the
    serving node passes ``loop.call_later``); with ``defer=None`` the
    commit runs SYNCHRONOUS — every append flushes immediately (tests,
    and any caller that wants classic sync-per-record semantics)."""

    def __init__(self, wal: WriteAheadLog,
                 defer: Optional[Callable[[float, Callable[[], None]],
                                          object]] = None,
                 window_micros: Optional[int] = None,
                 metrics=None,
                 async_exec: Optional[Callable] = None):
        self.wal = wal
        self.defer = defer
        # async_exec(work, done): run ``work`` OFF the owning thread and
        # call ``done(exception_or_None)`` back ON it.  The serving node
        # passes run_in_executor: an fsync is milliseconds of IO-wait,
        # and paying it inline would stall the single protocol thread
        # for the whole batch window (measured: ~3x goodput loss on a
        # slow /tmp).  None = fsync inline (tests, sim, CLI callers).
        self.async_exec = async_exec
        self.window_micros = (window_micros if window_micros is not None
                              else priced_window_micros(wal.directory))
        self.metrics = metrics
        # r16: optional drain hook run at the top of every flush — the
        # durable journal parks latest-wins facts (register rows) here so
        # one window's worth of transitions serializes ONCE, inside the
        # same write+fsync the window already pays.  Everything buffered
        # since the last flush dies together on a crash either way, so
        # deferring a latest-wins record to the flush it would have died
        # with changes no recoverable state.
        self.pre_flush: Optional[Callable[[], None]] = None
        # offload the fsync only when it costs more than the hop that
        # offloads it (both probed once per process; a tmpfs-class fsync
        # is cheaper inline, a slow filesystem still rides the worker)
        self._offload_pays = (async_exec is not None and
                              probe_fsync_micros(wal.directory)
                              >= probe_offload_micros())
        # serving nodes (worker wired) on a cheap-fsync device flush AT
        # the gate point: the window amortizes fsyncs, and an fsync
        # cheaper than a thread hop is also far cheaper than the timer
        # lateness a gated reply pays on a busy event loop (measured:
        # the dominant journal-on latency tax at saturation, not CPU)
        self._eager_gate = (async_exec is not None
                            and not self._offload_pays)
        # owner-supplied predicate: latest-wins facts parked outside the
        # WAL (register rows) that the next DRAINING flush serializes —
        # a waiter-less window with only these pending defers to the lag
        # horizon so they coalesce instead of flushing per window
        self.deferred_pending: Optional[Callable[[], bool]] = None
        self._lazy_armed = False
        self._timer_gen = 0
        self.failed = False
        self.n_flushes = 0
        self.n_fsync_failures = 0
        self.n_batch_records = 0
        self.n_lazy_rearms = 0
        self._waiters: List[Tuple[int, Callable[[], None]]] = []
        self._flush_scheduled = False
        self._sync_inflight = False
        # the async batch's captured files: a concurrent flush(sync=True)
        # must fsync these TOO before it may advance durable_seq past
        # records the worker has not confirmed yet
        self._inflight_files: List[tuple] = []

    # -- append / acknowledge ------------------------------------------------
    def append(self, doc: dict) -> Optional[int]:
        """One record into the current batch; returns its seq, or None
        when the record did NOT land (journal already degraded, or this
        very write failed and degraded it).  Raises nothing — after
        degrade, appends are absorbed and acked immediately (the
        in-memory journal remains the node's working state)."""
        if self.failed:
            return None
        try:
            seq = self.wal.append(doc)
        except OSError as exc:
            self._degrade(f"append failed: {exc!r}")
            return None
        if self.defer is None:
            self.flush()
        else:
            self._schedule_flush()
        return seq

    def after_durable(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once everything appended so far is durable."""
        if self.failed or self.wal.durable_seq >= self.wal.tail_seq:
            fn()
            return
        self._waiters.append((self.wal.tail_seq, fn))
        if self._eager_gate:
            self.flush(drain=False)
            return
        self._schedule_flush()

    def _schedule_flush(self) -> None:
        if self.defer is None or self.failed:
            return
        if self._flush_scheduled:
            if self._lazy_armed and self._waiters:
                # the armed timer sits at the lag horizon but a waiter
                # just appeared: supersede it with a window-delay timer
                # so gate latency keeps its normal bound (the generation
                # stamp makes the lazy timer's later firing a no-op)
                self._lazy_armed = False
                self._arm(self.window_micros / 1e6)
            return
        self._flush_scheduled = True
        self._arm(self.window_micros / 1e6)

    def _arm(self, delay_s: float) -> None:
        # generation-stamp every armed timer: re-arming invalidates any
        # outstanding timer, whose late firing would otherwise burn an
        # extra flush / lazy-rearm cycle per supersession
        self._timer_gen += 1
        gen = self._timer_gen
        self.defer(delay_s, lambda: self._window_close(gen))

    def schedule_window(self) -> None:
        """Public arm for callers that parked a deferred record (see
        ``pre_flush``) without appending: the next window close must run
        even if nothing else lands.  Synchronous mode (defer=None)
        flushes immediately — the deferral degenerates to eager."""
        if self.defer is None:
            self.flush()
        else:
            self._schedule_flush()

    def _window_close(self, gen: Optional[int] = None) -> None:
        if gen is not None and gen != self._timer_gen:
            return   # superseded timer
        was_lazy = self._lazy_armed
        self._flush_scheduled = False
        self._lazy_armed = False
        if (not self._waiters and not was_lazy and not self.failed
                and self.defer is not None
                and (self.wal.tail_seq > self.wal.durable_seq
                     or (self.deferred_pending is not None
                         and self.deferred_pending()))):
            # nobody is waiting on durability: ONE deferral to the lag
            # horizon instead of a flush cycle per window — appended
            # records and parked latest-wins facts batch until then (a
            # waiter arriving meanwhile gets a window-delay timer from
            # _schedule_flush, keeping its normal latency bound)
            self.n_lazy_rearms += 1
            self._flush_scheduled = True
            self._lazy_armed = True
            self._arm(LAZY_MAX_LAG_MICROS / 1e6)
            return
        self.flush()

    # -- the durability point ------------------------------------------------
    def flush(self, sync: bool = False, drain: bool = True) -> None:
        """fsync the batch and release every waiter it covers.  With
        ``async_exec`` wired the fsync runs on a worker thread (one in
        flight at a time; a batch that lands mid-sync triggers a
        follow-up); ``sync=True`` forces the inline path — the
        flush-before-issue HLC reservation needs a blocking guarantee.
        ``drain=False`` skips the ``pre_flush`` drain of parked
        latest-wins facts: the at-gate eager flush syncs exactly what a
        waiter gates on, and register rows keep coalescing toward their
        own lag-horizon flush (crash-equivalent — a latest-wins fact
        deferred to the flush it would have died with changes no
        recoverable state)."""
        if drain and self.pre_flush is not None:
            try:
                # drain deferred latest-wins records INTO this batch (the
                # tail_seq read below must see them)
                self.pre_flush()
            except Exception as exc:   # a drain bug must not wedge the
                import sys             # durability point
                print(f"[journal] pre_flush failed: {exc!r}",
                      file=sys.stderr)
        if self.failed:
            self._release(self.wal.tail_seq)
            return
        pending = self.wal.tail_seq - self.wal.durable_seq
        if pending <= 0:
            self._release(self.wal.durable_seq)
            return
        if self._offload_pays and not sync:
            self._flush_async()
            return
        # inline path (sync=True, or no worker wired).  If a worker batch
        # is in flight its files were removed from the dirty set — fsync
        # them HERE TOO before claiming their records durable (concurrent
        # fsync of one fd is kernel-safe; the worker's own completion
        # then lands as a no-op behind the max() guard).
        t0 = time.perf_counter_ns()
        tail, files = self.wal.begin_sync()
        try:
            self.wal.sync_files(files + self._inflight_files)
        except OSError as exc:
            self._degrade(f"fsync failed: {exc!r}")
            self._release(self.wal.tail_seq)
            return
        self.wal.complete_sync(tail, reap=not self._sync_inflight)
        self._account(pending, (time.perf_counter_ns() - t0) // 1_000)
        self._release(tail)

    def _flush_async(self) -> None:
        if self._sync_inflight:
            # the in-flight sync's completion re-checks for new records
            return
        self._sync_inflight = True
        base = self.wal.durable_seq
        tail, files = self.wal.begin_sync()
        self._inflight_files = files
        t0 = time.perf_counter_ns()

        def work():
            self.wal.sync_files(files)

        def done(exc) -> None:
            self._sync_inflight = False
            self._inflight_files = []
            if exc is not None:
                # ValueError = file closed under the worker (shutdown
                # race): same degrade path as a failed fsync, never an
                # unhandled loop exception
                if isinstance(exc, (OSError, ValueError)):
                    self._degrade(f"fsync failed: {exc!r}")
                    self._release(self.wal.tail_seq)
                    return
                raise exc
            self.wal.complete_sync(tail)
            self._account(tail - base,
                          (time.perf_counter_ns() - t0) // 1_000)
            self._release(tail)
            # records that landed while the batch was syncing: open the
            # next window (don't fsync back-to-back for a near-empty
            # batch unless someone is waiting)
            if self.wal.tail_seq > tail and (self._waiters
                                             or self.defer is None):
                if self.defer is not None:
                    self._schedule_flush()
                else:
                    self.flush()

        self.async_exec(work, done)

    def _account(self, batch: int, micros: int) -> None:
        self.n_flushes += 1
        self.n_batch_records += batch
        if self.metrics is not None:
            self.metrics.counter("journal_fsyncs").inc()
            self.metrics.histogram("journal_fsync_micros").observe(micros)
            self.metrics.histogram("journal_commit_batch").observe(batch)

    def _release(self, durable_seq: int) -> None:
        if not self._waiters:
            return
        ready = [fn for seq, fn in self._waiters if seq <= durable_seq]
        self._waiters = [(seq, fn) for seq, fn in self._waiters
                         if seq > durable_seq]
        for fn in ready:
            fn()

    def _degrade(self, why: str) -> None:
        """Durability can no longer be promised: loud, counted, alive."""
        if not self.failed:
            self.failed = True
            self.n_fsync_failures += 1
            if self.metrics is not None:
                self.metrics.counter("journal_fsync_failures").inc()
            print(f"[journal] DEGRADED (durability off): {why}",
                  file=sys.stderr, flush=True)
        # a failed journal still releases everyone: availability over a
        # promise it can no longer make
        self._release(self.wal.tail_seq)

    def stats(self) -> dict:
        return {
            "window_micros": self.window_micros,
            "flushes": self.n_flushes,
            "batch_records": self.n_batch_records,
            "fsync_failures": self.n_fsync_failures,
            "lazy_rearms": self.n_lazy_rearms,
            "fsync_offloaded": self._offload_pays,
            "failed": self.failed,
            "pending_waiters": len(self._waiters),
        }
