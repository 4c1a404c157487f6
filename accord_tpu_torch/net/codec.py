"""Versioned binary wire codec for the TCP serving surface (r16).

The r12 transport framed every ``{src, dest, body}`` packet as JSON behind
a 4-byte length prefix.  JSON is kept as the DEBUG codec (``--wire-codec
json``: human-greppable node logs, wire captures readable in any tool);
the serving default is a compact tag-length-value encoding that cuts both
bytes and encode/decode CPU on the hot path.

Frame payloads are SELF-DESCRIBING: a binary payload starts with a magic
byte (``0xB1``) that can never begin a JSON document, followed by a
format-version byte, so one connection can carry both codecs (a debug
JSON client talking to a binary-codec cluster just works) and a codec
fallback never needs renegotiation.  On top of the sniffing, every
:class:`~accord_tpu.net.transport.PeerLink` announces its codec in a
``codec_hello`` control body as the first frame after every (re)connect —
the handshake half of version negotiation on strictly one-way links: the
receiver validates the announced version and surfaces a mismatch loudly
in its stats/logs instead of silently dropping frames one CodecError at a
time.

Layout (version 1), behind the existing 4-byte length prefix::

    [0]    0xB1 magic
    [1]    version (0x01)
    [2]    kind     -- body-type hint for pre-decode dispatch (below)
    [3]    len(src)  + src utf-8   (1-byte length: node/client names)
    [...]  len(dest) + dest utf-8
    [...]  msg_id as signed 8-byte big-endian (NO_MSG_ID when absent)
    [...]  body as one msgpack document

The (kind, src, msg_id) prelude exists so ADMISSION can act before any
body decode: a shed under overload must stay the cheapest possible
outcome, and with the binary codec the server decides shed-vs-admit from
a fixed-offset header read — the txn ops, datums and payload trees of a
shed request are never materialized (``peek_header``).

The value encoding is msgpack (already in the image; C extension), which
is itself a standardized TLV format — the golden pins in
``tests/test_net.py`` freeze OUR layout (magic/version/prelude + the
msgpack bytes), so any unversioned change to either layer fails tier-1.
Integers beyond msgpack's 64-bit range (possible in principle for
arbitrary-precision timestamp words) make ``encode_packet`` fall back to
a JSON payload for THAT frame — the sniffing decoder makes the fallback
free and lossless.

When msgpack is unavailable (it is baked into this image, but the codec
must degrade, not crash), ``binary_available()`` is False and every
encoder falls back to JSON; ``--wire-codec binary`` then serves JSON and
says so once on stderr.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

try:
    import msgpack as _msgpack
except Exception:   # pragma: no cover - msgpack is baked into the image
    _msgpack = None

MAGIC = 0xB1
VERSION = 1
# versions this decoder accepts (grows on format bumps: old pinned frames
# must keep decoding forever — the golden-frame compatibility gate)
SUPPORTED_VERSIONS = (1,)

# body-type hints for pre-decode dispatch; 0 = no hint (full decode).
# These are HINTS riding next to the body (which stays self-contained):
# an unknown future kind byte decodes fine — the receiver just takes the
# full-decode path.
KIND_OTHER = 0
KIND_TXN = 1
KIND_ACCORD_REQ = 2
KIND_ACCORD_RSP = 3
KIND_ACCORD_FAIL = 4
KIND_BATCH = 5
KIND_CONTROL = 6

_KIND_OF = {
    "txn": KIND_TXN,
    "accord_req": KIND_ACCORD_REQ,
    "accord_rsp": KIND_ACCORD_RSP,
    "accord_fail": KIND_ACCORD_FAIL,
    "accord_batch": KIND_BATCH,
    "ping": KIND_CONTROL,
    "stats": KIND_CONTROL,
    "dump": KIND_CONTROL,
    "codec_hello": KIND_CONTROL,
    # elastic serving (reconfig) control verbs: kind-hinted so a future
    # pre-decode dispatch can prioritize them; bodies stay self-contained
    "reconfigure": KIND_CONTROL,
    "topo_new": KIND_CONTROL,
    "epoch_sync": KIND_CONTROL,
    "topo_fetch": KIND_CONTROL,
}

_I64 = struct.Struct(">q")
NO_MSG_ID = -(1 << 63)   # "body carries no msg_id" sentinel in the prelude


class CodecError(ValueError):
    """Codec-layer protocol violation (bad magic/version/prelude)."""


def binary_available() -> bool:
    return _msgpack is not None


def _prelude(packet: dict) -> bytes:
    body = packet.get("body") or {}
    kind = _KIND_OF.get(body.get("type"), KIND_OTHER)
    src = str(packet.get("src", "")).encode("utf-8")
    dest = str(packet.get("dest", "")).encode("utf-8")
    if len(src) > 255 or len(dest) > 255:
        raise CodecError("src/dest over 255 bytes")
    msg_id = body.get("msg_id")
    if not isinstance(msg_id, int) or isinstance(msg_id, bool) \
            or not (NO_MSG_ID < msg_id < (1 << 63)):
        msg_id = NO_MSG_ID
    return (bytes((MAGIC, VERSION, kind, len(src))) + src
            + bytes((len(dest),)) + dest + _I64.pack(msg_id))


def encode_packet(packet: dict, codec: str = "json") -> bytes:
    """One packet dict -> payload bytes (no length prefix).  ``codec`` is
    "json" or "binary"; binary falls back to JSON per-frame when msgpack
    is missing or a value exceeds its integer range."""
    if codec == "binary" and _msgpack is not None:
        try:
            return _prelude(packet) + _msgpack.packb(packet.get("body"))
        except (OverflowError, TypeError, ValueError):
            pass   # out-of-range int / exotic value: JSON carries it
    return json.dumps(packet, separators=(",", ":")).encode("utf-8")


def is_binary(payload) -> bool:
    return len(payload) > 1 and payload[0] == MAGIC


def decode_payload(payload: bytes) -> dict:
    """Payload bytes -> packet dict, sniffing the codec per frame."""
    if not is_binary(payload):
        return json.loads(payload if isinstance(payload, (bytes, bytearray))
                          else bytes(payload))
    version = payload[1]
    if version not in SUPPORTED_VERSIONS:
        raise CodecError(f"unsupported binary codec version {version} "
                         f"(supported: {SUPPORTED_VERSIONS})")
    if _msgpack is None:   # pragma: no cover - image always has msgpack
        raise CodecError("binary frame received but msgpack is unavailable")
    try:
        ls = payload[3]
        off = 4
        src = payload[off:off + ls].decode("utf-8"); off += ls
        ld = payload[off]; off += 1
        dest = payload[off:off + ld].decode("utf-8"); off += ld
        off += 8   # msg_id prelude copy: the body below is authoritative
        body = _msgpack.unpackb(payload[off:])
    except (IndexError, UnicodeDecodeError) as exc:
        # a truncated/garbled prelude must surface as the codec-error
        # contract (FrameServer counts it and drops the connection), not
        # an uncaught IndexError out of the connection coroutine
        raise CodecError(f"malformed binary prelude: {exc!r}") from exc
    return {"src": src, "dest": dest, "body": body}


def peek_header(payload) -> Optional[Tuple[int, str, Optional[int]]]:
    """(kind, src, msg_id) from a binary frame WITHOUT touching the body
    — the pre-decode admission path.  None for JSON frames (the debug
    codec takes the full-decode path) or anything malformed (the caller
    falls through to decode_payload, which raises properly)."""
    try:
        if not is_binary(payload) or payload[1] not in SUPPORTED_VERSIONS:
            return None
        kind = payload[2]
        ls = payload[3]
        off = 4
        src = bytes(payload[off:off + ls]).decode("utf-8"); off += ls
        ld = payload[off]; off += 1 + ld
        (msg_id,) = _I64.unpack_from(payload, off)
        return kind, src, (None if msg_id == NO_MSG_ID else msg_id)
    except (IndexError, struct.error, UnicodeDecodeError):
        return None


def hello_body(me: str, codec: str, epoch: Optional[int] = None) -> dict:
    """The link-handshake announcement: first frame a PeerLink sends after
    every (re)connect.  Carries the codec name and the format version the
    link will speak so the receiving node can validate support ONCE and
    report a mismatch in its stats instead of per-frame decode errors.

    ``epoch`` (r17, elastic serving) announces the sender's current
    topology epoch when known: a receiver behind the announced epoch
    fetches the gap the moment the link forms — the catch-up trigger for
    nodes that slept through a reconfiguration.  Omitted when None, so
    pre-r17 hellos (and their golden pins) are unchanged bytes; mixed-
    epoch and epochless hellos interoperate on one stream."""
    body = {"type": "codec_hello", "from": me, "codec": codec,
            "version": VERSION if codec == "binary" else 0}
    if epoch is not None:
        body["epoch"] = epoch
    return body
