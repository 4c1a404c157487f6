"""Snapshot + compaction: bound the WAL by periodically serializing state.

A pure WAL replays from the beginning of time; the snapshot is the floor
that lets it forget.  ``write_snapshot`` serializes the journal's whole
in-memory state (registers + message bodies + watermarks + HLC
reservation + client-reply dedupe + data-store log) stamped with the WAL
sequence it covers, using the same CRC frame as a segment record so a
torn snapshot is detected exactly like a torn WAL tail.  Recovery loads
the NEWEST snapshot that validates (an older intact one backstops a torn
newest — which is why the previous snapshot is kept until the next one
lands) and replays only WAL records past its floor.

Segments wholly below the floor are recycled by the caller
(``WriteAheadLog.drop_below``) — the same RedundantBefore-floor shape the
attribution/cleanup path uses: state below a durable watermark is
answered by the watermark, so the log entries that built it are dead.

Write protocol (crash-safe on POSIX rename semantics): tmp file → write
frame → fsync → rename to final name → fsync dir.  A crash anywhere
leaves either the old snapshot set or the new one, never a half-visible
file under the final name.
"""

from __future__ import annotations

import os
import re
import zlib
from typing import List, Optional, Tuple

from . import record as rec_mod
from . import segment as seg_mod
from .segment import fsync_dir, frame

_SNAP_RE = re.compile(r"^snap-(\d{16})\.snap$")
KEEP_SNAPSHOTS = 2


def _snap_paths(directory: str) -> List[Tuple[int, str]]:
    out = []
    for name in os.listdir(directory):
        m = _SNAP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def write_snapshot(directory: str, floor_seq: int, state: dict,
                   metrics=None) -> str:
    """Durably persist ``state`` covering WAL records <= floor_seq."""
    # same versioned record codec as the WAL (sniffed on load, so a JSON
    # snapshot from an older process keeps loading): the whole-state doc
    # is megabytes at scale, and serializing it shares the GIL with the
    # protocol thread even on the commit worker
    payload = rec_mod.encode_record({"floor": floor_seq, "state": state},
                                    rec_mod.default_codec())
    final = os.path.join(directory, f"snap-{floor_seq:016d}.snap")
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(frame(payload))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    fsync_dir(directory)
    if metrics is not None:
        metrics.counter("journal_snapshots").inc()
        metrics.gauge("journal_snapshot_floor").set(floor_seq)
    # retire all but the newest KEEP_SNAPSHOTS (the runner-up backstops a
    # torn newest; anything older is dead weight)
    snaps = _snap_paths(directory)
    for _floor, path in snaps[:-KEEP_SNAPSHOTS]:
        try:
            os.unlink(path)
        except OSError:
            pass
    return final


def load_latest(directory: str) -> Tuple[int, Optional[dict]]:
    """Newest VALID snapshot as ``(floor_seq, state)``; ``(0, None)``
    when none validates (fresh directory, or every snapshot torn — the
    WAL then replays from its own beginning)."""
    if not os.path.isdir(directory):
        return 0, None
    for floor, path in reversed(_snap_paths(directory)):
        try:
            data = open(path, "rb").read()
        except OSError:
            continue
        # one frame: reuse the segment scanner's CRC discipline by hand
        if len(data) < seg_mod._HDR.size:
            continue
        length, crc = seg_mod._HDR.unpack_from(data, 0)
        payload = data[seg_mod._HDR.size: seg_mod._HDR.size + length]
        if len(payload) != length or zlib.crc32(payload) != crc:
            continue   # torn/corrupt: fall back to the previous snapshot
        try:
            doc = rec_mod.decode_record(payload)
        except rec_mod.RecordError:
            # CRC-valid but unsupported version: a downgrade, not a torn
            # file — falling back to an older snapshot would silently
            # regress acked-durable state
            raise
        except ValueError:
            continue
        return int(doc["floor"]), doc["state"]
    return 0, None
