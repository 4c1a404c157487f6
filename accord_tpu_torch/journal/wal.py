"""Segmented write-ahead log: monotonic record sequence over segment files.

Layout of a journal directory::

    wal-00000000.seg     segment 0 (base seq 1)
    wal-00000001.seg     segment 1 (base seq = 1 + records in segment 0)
    recycle-0.seg        fully-snapshotted segment awaiting reuse
    snap-<floor>.snap    snapshots (journal/snapshot.py)

Records are docs serialized by the versioned record codec
(``journal/record.py``: 0xB2+version+msgpack by default, canonical JSON
as the debug codec and per-record fallback — decode sniffs, so mixed
journals replay fine); ``append`` stamps each with the next sequence
number under key ``"s"`` and frames it (segment.frame).  Segments roll at
``segment_bytes``; rolling creates (or RECYCLES) the next file and the
old one stays until the snapshot floor passes its last record, at which
point ``drop_below`` moves it into the recycle pool — reusing an
already-allocated file instead of paying create/unlink churn on every
roll (the reference's pre-allocated segment recycling).

Open-time recovery (``recovered`` after construction): segments are
scanned in index order; a torn/corrupt frame truncates that segment and
DROPS every later segment (sequence continuity is the replay contract —
bytes past a corruption are not attributable records), counting what was
lost.  The LAST segment reopens for append at its truncation point.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from . import record as rec_mod
from . import segment as seg_mod
from .segment import Segment, fsync_dir

_SEG_RE = re.compile(r"^wal-(\d{8})\.seg$")
_RECYCLE_RE = re.compile(r"^recycle-(\d+)\.seg$")
DEFAULT_SEGMENT_BYTES = 4 << 20
RECYCLE_POOL_CAP = 4


class _SealedInfo:
    """A closed-for-append segment the floor has not passed yet.  The
    file handle stays open (fobj) while the segment may still need an
    fsync from a batch that spanned a roll; closed when dropped."""

    __slots__ = ("path", "seg_index", "base_seq", "last_seq", "fobj")

    def __init__(self, path: str, seg_index: int, base_seq: int,
                 last_seq: int, fobj=None):
        self.path = path
        self.seg_index = seg_index
        self.base_seq = base_seq
        self.last_seq = last_seq
        self.fobj = fobj


class WriteAheadLog:
    def __init__(self, directory: str,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 record_codec: Optional[str] = None):
        self.directory = directory
        self.segment_bytes = segment_bytes
        # record payload codec for NEW appends; decode always sniffs, so
        # this never constrains what an existing journal may contain
        self.record_codec = (record_codec if record_codec is not None
                             else rec_mod.default_codec())
        os.makedirs(directory, exist_ok=True)
        # counters (mirrored into obs by the owning journal)
        self.n_appended = 0
        self.n_bytes = 0
        self.n_rolled = 0
        self.n_recycled = 0
        self.n_truncated_bytes = 0
        self.n_dropped_segments = 0
        self.recovered: List[dict] = []      # record docs found at open
        self._sealed: List[_SealedInfo] = []  # closed-for-append, live
        self._active: Optional[Segment] = None
        # (fileobj, path) written since the last sync began (a roll
        # mid-batch leaves TWO dirty files; one group-commit fsync must
        # cover both).  begin_sync() hands the list to the syncer —
        # possibly a worker thread — and new appends re-dirty the active
        # file for the NEXT batch.
        self._dirty: List[tuple] = []
        # handles of dropped segments awaiting close (a background sync
        # may still hold them: rename/unlink of an open fd is safe on
        # POSIX, fsync of a CLOSED one is not — so closing defers to the
        # next complete_sync, when no sync is in flight)
        self._retired: List[object] = []
        self._open_or_create()

    # -- open-time scan ------------------------------------------------------
    def _segment_paths(self) -> List[str]:
        out = []
        for name in os.listdir(self.directory):
            if _SEG_RE.match(name):
                out.append(os.path.join(self.directory, name))
        return sorted(out)

    def _recycle_paths(self) -> List[str]:
        out = []
        for name in os.listdir(self.directory):
            if _RECYCLE_RE.match(name):
                out.append(os.path.join(self.directory, name))
        return sorted(out)

    def _open_or_create(self) -> None:
        paths = self._segment_paths()
        tail_seq = 0
        live: List[_SealedInfo] = []     # (path, seg_index, base, last_seq)
        corrupt = False
        for i, path in enumerate(paths):
            if corrupt:
                # continuity broken earlier: these records are not
                # attributable — drop the file
                self.n_dropped_segments += 1
                os.unlink(path)
                continue
            header, payloads, valid_end, size = seg_mod.scan(path)
            if header is None:
                # torn at birth (crash between create and header sync)
                self.n_dropped_segments += 1
                self.n_truncated_bytes += size
                os.unlink(path)
                corrupt = True
                continue
            # identity + continuity checks: a crash between recycling a
            # pool file under a new wal-NN name and persisting its
            # truncate+header can leave the OLD segment's fully CRC-valid
            # frames under the new name — the header's own seg index then
            # disagrees with the filename (and its base gaps the
            # sequence).  Such a file is stale bytes, not records.
            fname_idx = int(_SEG_RE.match(os.path.basename(path)).group(1))
            stale = header[0] != fname_idx or (live and
                                               header[1] != tail_seq + 1)
            if stale:
                self.n_dropped_segments += 1
                self.n_truncated_bytes += size
                os.unlink(path)
                corrupt = True
                continue
            # a payload-less segment still pins the sequence: its base
            # says how many records preceded it (the predecessors may all
            # be recycled below the snapshot floor) — without this a
            # header-only tail reopens at tail_seq=0 and REISSUES seqs
            # under the floor, which the next recovery would skip
            if header[1] - 1 > tail_seq:
                tail_seq = header[1] - 1
            torn = size - valid_end
            if torn > 0:
                self.n_truncated_bytes += torn
                if i < len(paths) - 1:
                    # corruption mid-chain: later segments' records would
                    # gap the sequence — unreachable for replay
                    corrupt = True
            for payload in payloads:
                doc = rec_mod.decode_record(payload)
                tail_seq = int(doc["s"])
                self.recovered.append(doc)
            live.append(_SealedInfo(path, header[0], header[1], tail_seq))
        self.tail_seq = tail_seq
        self.durable_seq = tail_seq      # everything scanned IS on disk
        if live:
            self._active = Segment.open_existing(live[-1].path, tail_seq)
            self._sealed = live[:-1]
        else:
            self._active = self._new_segment(0, tail_seq + 1)

    def _new_segment(self, seg_index: int, base_seq: int) -> Segment:
        path = os.path.join(self.directory, f"wal-{seg_index:08d}.seg")
        pool = self._recycle_paths()
        if pool:
            # recycle: rename an already-allocated file over the new name
            # (truncate happens in create's "wb" open)
            os.replace(pool[0], path)
            self.n_recycled += 1
        s = Segment.create(path, seg_index, base_seq)
        fsync_dir(self.directory)
        return s

    # -- append / roll / sync ------------------------------------------------
    def append(self, doc: dict) -> int:
        """Stamp + frame + write one record; returns its sequence number.
        NOT durable until ``sync`` — the group commit owns that window."""
        seq = self.tail_seq + 1
        doc = dict(doc)
        doc["s"] = seq
        payload = rec_mod.encode_record(doc, self.record_codec)
        if self._active.size >= self.segment_bytes:
            self._roll(seq)
        if not any(f is self._active._f for f, _p in self._dirty):
            self._dirty.append((self._active._f, self._active.path))
        self._active.append(payload, seq)
        self.tail_seq = seq
        self.n_appended += 1
        self.n_bytes += len(payload)
        return seq

    def _roll(self, next_seq: int) -> None:
        """Seal the active segment and open (or recycle) the next.  The
        sealed file handle stays open and DIRTY — the next batch fsync
        covers it; closing here would block the caller on a sync."""
        old = self._active
        old._f.flush()
        self._sealed.append(_SealedInfo(old.path, old.seg_index,
                                        old.base_seq, old.last_seq,
                                        fobj=old._f))
        self._active = self._new_segment(old.seg_index + 1, next_seq)
        self.n_rolled += 1

    # -- the durability point (two-phase so a worker thread can own the
    #    fsyncs while the event loop keeps appending) ------------------------
    def begin_sync(self):
        """Capture the batch: (tail_seq_promised, [(fileobj, path)...]).
        New appends after this call re-dirty files for the NEXT batch."""
        files = self._dirty
        self._dirty = []
        return self.tail_seq, files

    @staticmethod
    def sync_files(files) -> None:
        """flush+fsync the captured files — safe OFF the owning thread."""
        from .segment import fsync_file
        for f, path in files:
            fsync_file(f, path)

    def complete_sync(self, tail_seq: int, reap: bool = True) -> None:
        if tail_seq > self.durable_seq:
            self.durable_seq = tail_seq
        # handles retired by drop_below close only when the caller can
        # vouch no sync still holds them (fsync of a closed fd raises;
        # of a renamed/unlinked open one is fine)
        if reap:
            for f in self._retired:
                try:
                    f.close()
                except OSError:
                    pass
            self._retired = []

    def sync(self) -> int:
        """Synchronous fsync of every dirty segment; returns the durable
        tail.  (The group commit's async mode drives the three-phase API
        directly.)"""
        tail, files = self.begin_sync()
        try:
            self.sync_files(files)
        except OSError:
            # the batch did NOT become durable; re-dirty for the caller's
            # degrade handling (the files may still close cleanly later)
            self._dirty = files + self._dirty
            raise
        self.complete_sync(tail)
        return self.durable_seq

    # -- compaction ----------------------------------------------------------
    def drop_below(self, floor_seq: int) -> int:
        """Recycle sealed segments whose every record is <= floor_seq
        (covered by a durable snapshot).  Returns segments dropped."""
        dropped = 0
        keep: List[_SealedInfo] = []
        for s in self._sealed:
            if s.last_seq <= floor_seq:
                self._recycle_file(s.path)
                if s.fobj is not None:
                    self._retired.append(s.fobj)
                dropped += 1
            else:
                keep.append(s)
        self._sealed = keep
        if dropped:
            fsync_dir(self.directory)
        return dropped

    def _recycle_file(self, path: str) -> None:
        pool = self._recycle_paths()
        if len(pool) >= RECYCLE_POOL_CAP:
            os.unlink(path)
            return
        used = {int(_RECYCLE_RE.match(os.path.basename(p)).group(1))
                for p in pool}
        n = 0
        while n in used:
            n += 1
        os.replace(path, os.path.join(self.directory, f"recycle-{n}.seg"))

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._active is not None:
            try:
                self.sync()
            except OSError:
                pass
            self._active.close()
            self._active = None
        for s in self._sealed:
            if s.fobj is not None:
                try:
                    s.fobj.close()
                except OSError:
                    pass
                s.fobj = None
        for f in self._retired:
            try:
                f.close()
            except OSError:
                pass
        self._retired = []

    def stats(self) -> Dict[str, int]:
        return {
            "tail_seq": self.tail_seq,
            "durable_seq": self.durable_seq,
            "appended": self.n_appended,
            "bytes": self.n_bytes,
            "rolled": self.n_rolled,
            "recycled": self.n_recycled,
            "truncated_tail_bytes": self.n_truncated_bytes,
            "dropped_segments": self.n_dropped_segments,
            "live_segments": len(self._sealed) + 1,
        }
