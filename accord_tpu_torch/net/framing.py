"""Length-prefixed framing for the TCP serving surface.

One frame = 4-byte big-endian payload length + payload.  The payload is
one ``{src, dest, body}`` packet under either wire codec (``net.codec``):
UTF-8 JSON (the r12 format, kept as the debug codec) or the versioned
binary encoding, sniffed per frame by its magic byte.  The decoder is a
plain byte-stream state machine so a frame survives ANY segmentation the
kernel chooses — partial reads mid-header, mid-payload, or many frames
coalesced into one read — and the golden-frame test asserts byte-identical
round trips over a real loopback socket under all three.

A frame larger than ``MAX_FRAME`` is a protocol violation (a desynced or
hostile peer), surfaced as :class:`FrameError` so the connection layer can
drop the link instead of allocating unboundedly.
"""

from __future__ import annotations

import struct
from typing import List

from .codec import decode_payload, encode_packet

_LEN = struct.Struct(">I")

# largest legal payload: generously above any protocol message (a full
# CheckStatusOk with writes), far below anything that smells like reading
# TLS/HTTP bytes as a length prefix
MAX_FRAME = 16 * 1024 * 1024


class FrameError(ValueError):
    """Framing-layer protocol violation (oversized/garbage length)."""


def encode_frame(packet: dict, codec: str = "json") -> bytes:
    """One packet dict -> length-prefixed wire bytes under ``codec``
    ("json" default — the debug codec — or "binary").  Under either,
    key order is preserved, so decode -> re-encode reproduces the exact
    bytes (the golden-frame contract)."""
    return prefix_payload(encode_packet(packet, codec))


def prefix_payload(payload: bytes) -> bytes:
    """Length-prefix an ALREADY-encoded frame payload (the server's
    encode-once send path; chunk streaming re-slices the same bytes)."""
    if len(payload) > MAX_FRAME:
        raise FrameError(f"frame of {len(payload)} bytes exceeds MAX_FRAME")
    return _LEN.pack(len(payload)) + payload


class FrameDecoder:
    """Incremental decoder: ``feed(chunk)`` returns every COMPLETE packet
    the stream holds so far (codec sniffed per frame), buffering any
    trailing partial frame.  ``feed_raw`` returns the undecoded payloads
    instead — the server's pre-decode admission path."""

    __slots__ = ("_buf",)

    def __init__(self):
        self._buf = bytearray()

    def feed_raw(self, data: bytes) -> List[bytes]:
        self._buf.extend(data)
        out: List[bytes] = []
        while True:
            if len(self._buf) < _LEN.size:
                return out
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME:
                raise FrameError(f"frame length {n} exceeds MAX_FRAME "
                                 f"(desynced or non-protocol peer)")
            if len(self._buf) < _LEN.size + n:
                return out
            payload = bytes(self._buf[_LEN.size:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            out.append(payload)

    def feed(self, data: bytes) -> List[dict]:
        return [decode_payload(p) for p in self.feed_raw(data)]

    def pending_bytes(self) -> int:
        return len(self._buf)
