"""Crash-recovery replay: snapshot floor first, then the WAL tail.

``replay(journal)`` runs inside :class:`DurableJournal` construction:

1. load the newest VALID snapshot (``snapshot.load_latest`` — CRC-checked,
   an intact runner-up backstops a torn newest) and install its state;
2. replay every WAL record with ``seq > floor`` through the journal's own
   record semantics (``apply_record`` — messages re-enter
   ``record_message``, registers re-install their fixed-width columns, so
   the recovered object is bit-for-bit the journal a crash interrupted);
3. recycle segments the floor strands.

The WAL scan itself (torn-tail truncation, CRC rejection, dropped
unreachable segments) already happened when ``WriteAheadLog`` opened; this
module turns the surviving records back into journal state and reports
the census (``replay_stats``).

The recovered journal then takes the EXISTING restart path: the server
builds its ``Node`` with ``journal=`` and calls ``restore(node)`` —
identical to the sim's ``Cluster.restart_node`` — so one reconstruction
code path serves simulated restarts and real kill -9 recovery.

``open_journal`` is the serving node's one-call entry point.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from . import snapshot as snapshot_mod


def replay(journal) -> dict:
    """Rebuild ``journal``'s in-memory state from its directory.  Returns
    the replay census (also stored as ``journal.replay_stats``)."""
    t0 = time.perf_counter_ns()
    floor, state = snapshot_mod.load_latest(journal.directory)
    journal._replaying = True
    replayed = skipped = bad = 0
    try:
        if state is not None:
            journal.install_state(state)
        for doc in journal.wal.recovered:
            if doc["s"] <= floor:
                skipped += 1     # already inside the snapshot
                continue
            try:
                journal.apply_record(doc)
                replayed += 1
            except Exception as exc:   # one bad record must not lose the
                bad += 1               # rest of the tail
                print(f"[journal] replay skipped record "
                      f"seq={doc.get('s')} kind={doc.get('k')!r}: "
                      f"{exc!r}", file=sys.stderr)
    finally:
        journal._replaying = False
    journal.wal.drop_below(floor)
    # the parsed tail served its one purpose — holding every record doc
    # for the process lifetime would pin the whole WAL in memory
    journal.wal.recovered = []
    wall = (time.perf_counter_ns() - t0) // 1_000
    stats = {
        "snapshot_floor": floor,
        "snapshot_loaded": state is not None,
        "replayed": replayed,
        "skipped": skipped,
        "bad_records": bad,
        "torn_tail_bytes": journal.wal.n_truncated_bytes,
        "dropped_segments": journal.wal.n_dropped_segments,
        "wall_micros": wall,
        "records_per_sec": (replayed * 1_000_000 // wall) if wall else 0,
    }
    if journal.metrics is not None:
        journal.metrics.gauge("journal_replay_records").set(replayed)
        journal.metrics.gauge("journal_replay_micros").set(wall)
        journal.metrics.gauge("journal_torn_tail_bytes").set(
            journal.wal.n_truncated_bytes)
    return stats


def open_journal(directory: str, *,
                 segment_bytes: Optional[int] = None,
                 snapshot_every: Optional[int] = None,
                 window_micros: Optional[int] = None,
                 defer=None, metrics=None, async_exec=None,
                 sync_policy: Optional[str] = None):
    """The serving node's entry point: open-or-recover a DurableJournal
    at ``directory`` (created if absent)."""
    from .durable import DEFAULT_SNAPSHOT_EVERY, DurableJournal
    from .wal import DEFAULT_SEGMENT_BYTES
    j = DurableJournal(
        directory,
        segment_bytes=segment_bytes or DEFAULT_SEGMENT_BYTES,
        snapshot_every=snapshot_every or DEFAULT_SNAPSHOT_EVERY,
        window_micros=window_micros, defer=defer, metrics=metrics,
        async_exec=async_exec, sync_policy=sync_policy or "client")
    rs = j.replay_stats
    if rs["replayed"] or rs["snapshot_loaded"]:
        print(f"[journal] recovered {directory}: "
              f"snapshot_floor={rs['snapshot_floor']} "
              f"replayed={rs['replayed']} records in "
              f"{rs['wall_micros'] / 1e3:.1f}ms "
              f"(torn_tail={rs['torn_tail_bytes']}B "
              f"bad={rs['bad_records']})", file=sys.stderr, flush=True)
    return j
