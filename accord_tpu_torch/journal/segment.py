"""One WAL segment: length+CRC32-framed records in a fixed-size file.

The frame is the journal's only on-disk unit::

    [u32 length][u32 crc32(payload)][payload bytes]

(big-endian, crc32 over the payload only).  A segment starts with a HEADER
frame — canonical JSON ``{"magic", "ver", "seg", "base"}`` — so a scan can
re-derive the segment's index and base sequence number without trusting the
filename, and every later frame is one record payload.

Torn-tail discipline (the crash contract): a kill -9 / power cut may leave
the final frame partially written.  ``scan`` walks frames until the first
one that is short, oversized or CRC-mismatched and reports that offset;
the caller truncates there (``Segment.open_existing``), so a reopened
segment ends at the last VERIFIED frame — a torn tail can lose the
unacknowledged tail records but can never mis-replay bytes as a record.

Every physical I/O consults the seedable disk faults in ``utils.faults``
(torn_write / short_read / failed_fsync), the storage-boundary analogue of
the r07 device faults: draws come only from the injected RandomSource, so
a seeded fault run replays the exact same torn bytes.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import List, Optional, Tuple

from ..utils import faults

MAGIC = "accwal"
VERSION = 1
_HDR = struct.Struct(">II")          # (length, crc32)
# a frame length beyond this is garbage, not a record (same defensive
# posture as net.framing.MAX_FRAME: never allocate from untrusted bytes)
MAX_RECORD = 64 * 1024 * 1024


class SegmentError(RuntimeError):
    """A segment file violates the format in a way truncation can't fix
    (bad magic / unknown version): the operator must intervene."""


def frame(payload: bytes) -> bytes:
    if len(payload) > MAX_RECORD:
        raise SegmentError(f"record of {len(payload)} bytes exceeds "
                           f"MAX_RECORD={MAX_RECORD}")
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def header_payload(seg_index: int, base_seq: int) -> bytes:
    return json.dumps({"magic": MAGIC, "ver": VERSION, "seg": seg_index,
                       "base": base_seq},
                      sort_keys=True, separators=(",", ":")).encode()


def parse_header(payload: bytes) -> Tuple[int, int]:
    doc = json.loads(payload.decode())
    if doc.get("magic") != MAGIC:
        raise SegmentError(f"bad segment magic {doc.get('magic')!r}")
    if doc.get("ver") != VERSION:
        raise SegmentError(f"unknown segment version {doc.get('ver')!r}")
    return int(doc["seg"]), int(doc["base"])


def _read_all(path: str) -> bytes:
    """Whole-file read with the short_read fault at the boundary: a fired
    fault returns a drawn prefix (the transient-I/O shape recovery must
    absorb as an unreadable tail)."""
    with open(path, "rb") as f:
        data = f.read()
    if faults.disk_fault_fires("short_read"):
        cut = int(len(data) * faults.disk_fault_fraction("short_read"))
        return data[:cut]
    return data


def scan(path: str) -> Tuple[Optional[Tuple[int, int]], List[bytes], int, int]:
    """Walk one segment's frames.

    Returns ``(header, payloads, valid_end, file_size)``: the parsed
    ``(seg_index, base_seq)`` header (None if even the header frame is
    unreadable — an empty/torn-at-birth segment), the record payloads in
    order, the byte offset just past the last VALID frame (the truncation
    point for a torn tail) and the actual size read."""
    data = _read_all(path)
    size = len(data)
    off = 0
    header: Optional[Tuple[int, int]] = None
    payloads: List[bytes] = []
    first = True
    while True:
        if off + _HDR.size > size:
            break
        length, crc = _HDR.unpack_from(data, off)
        if length > MAX_RECORD or off + _HDR.size + length > size:
            break
        payload = data[off + _HDR.size: off + _HDR.size + length]
        if zlib.crc32(payload) != crc:
            break
        if first:
            try:
                header = parse_header(payload)
            except (SegmentError, ValueError, KeyError):
                break
            first = False
        else:
            payloads.append(payload)
        off += _HDR.size + length
    return header, payloads, off, size


class Segment:
    """One open-for-append segment.  Writes go straight to the OS (the
    group commit's batching window is the only buffering layer the journal
    has — a second user-space buffer would just double the torn surface);
    ``sync`` is the durability point."""

    def __init__(self, path: str, seg_index: int, base_seq: int,
                 fobj: io.FileIO, size: int, last_seq: int):
        self.path = path
        self.seg_index = seg_index
        self.base_seq = base_seq
        self.last_seq = last_seq        # highest record seq written here
        self._f = fobj
        self.size = size

    # -- creation / reopen ---------------------------------------------------
    @classmethod
    def create(cls, path: str, seg_index: int, base_seq: int) -> "Segment":
        f = open(path, "wb")
        hdr = frame(header_payload(seg_index, base_seq))
        f.write(hdr)
        return cls(path, seg_index, base_seq, f, len(hdr), base_seq - 1)

    @classmethod
    def open_existing(cls, path: str, last_seq: int) -> "Segment":
        """Reopen a scanned segment for append, truncating any torn tail
        first (``scan`` already decided where the last valid frame ends)."""
        header, _payloads, valid_end, size = scan(path)
        if header is None:
            raise SegmentError(f"{path}: unreadable segment header")
        f = open(path, "r+b")
        if valid_end < size:
            f.truncate(valid_end)
        f.seek(valid_end)
        return cls(path, header[0], header[1], f, valid_end, last_seq)

    # -- append / sync -------------------------------------------------------
    def append(self, payload: bytes, seq: int) -> None:
        buf = frame(payload)
        if faults.disk_fault_fires("torn_write"):
            # persist only a drawn prefix, then surface the failure: the
            # in-process analogue of dying mid-write (the next reopen must
            # truncate this tail via the CRC scan)
            cut = int(len(buf) * faults.disk_fault_fraction("torn_write"))
            self._f.write(buf[:cut])
            self._f.flush()
            self.size += cut
            raise faults.TornWriteFault(
                f"injected torn write: {cut}/{len(buf)} bytes of seq {seq}")
        self._f.write(buf)
        self.size += len(buf)
        self.last_seq = seq

    def sync(self) -> None:
        fsync_file(self._f, self.path)

    def close(self) -> None:
        try:
            self._f.flush()
        finally:
            self._f.close()


def fsync_file(f, path: str = "") -> None:
    """flush + fsync one open file, honoring the injected fsync fault.
    Safe to call from a worker thread while the owning event loop keeps
    appending: the fsync covers at least every byte written before the
    flush, which is all the caller's captured tail promises."""
    f.flush()
    if faults.disk_fault_fires("failed_fsync"):
        raise faults.FailedFsyncFault(f"injected fsync failure on {path}")
    os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    """Durably record directory-level changes (segment create/rename):
    without this a crash can lose the file NAME even though its bytes were
    fsynced."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
