"""Versioned binary record format for WAL and snapshot payloads (r16).

The r13 journal serialized every record doc as canonical JSON inside its
CRC frame.  Once the wire went binary (``net/codec.py``) the WAL's
json.dumps/json.loads per record became the largest per-txn serving tax
(`durability_verdict` measured journal-on goodput at ~0.70x journal-off
against a 0.9 floor) — so the record payload gets the SAME discipline as
the wire: a magic byte that can never begin a JSON document, a format
version byte, and a msgpack body, with canonical JSON retained as the
debug codec and as the per-record fallback for values msgpack cannot
carry (>64-bit integers, possible in principle for arbitrary-precision
timestamp words).

Layout (version 1), inside the segment CRC frame::

    [0]    0xB2 magic   (distinct from the wire codec's 0xB1)
    [1]    version (0x01)
    [2:]   record doc as one msgpack document

Decoding SNIFFS per payload — a journal written by a JSON-codec process
replays under a binary-codec process and vice versa, and one segment may
legally mix both (per-record fallback).  An unknown version byte raises
:class:`RecordError` out of the WAL open — the same operator-must-
intervene posture as an unknown SEGMENT version (downgrade under a newer
journal must fail loudly, never silently truncate CRC-valid records as
if they were a torn tail).  The golden pins in
``tests/test_wal.py`` freeze the v1 bytes exactly as the wire pins
freeze theirs: an unversioned format change fails tier-1, and every
supported version's pins must decode forever.

Knob: ``ACCORD_TPU_WAL_CODEC=json|binary`` (default binary; JSON is the
human-greppable debug codec, same role as ``--wire-codec json``).
"""

from __future__ import annotations

import json
import os

try:
    import msgpack as _msgpack
except Exception:   # pragma: no cover - msgpack is baked into the image
    _msgpack = None

MAGIC = 0xB2
VERSION = 1
# versions this decoder accepts (grows on format bumps: old journals on
# disk must keep replaying forever — the golden-pin compatibility gate)
SUPPORTED_VERSIONS = (1,)
_PREFIX = bytes((MAGIC, VERSION))


class RecordError(ValueError):
    """Record-layer format violation (unknown version byte)."""


def binary_available() -> bool:
    return _msgpack is not None


def default_codec() -> str:
    """Resolve the process default: binary unless the debug knob or a
    missing msgpack says JSON."""
    want = os.environ.get("ACCORD_TPU_WAL_CODEC", "binary")
    if want not in ("json", "binary"):
        raise ValueError(f"ACCORD_TPU_WAL_CODEC={want!r} "
                         f"(want json|binary)")
    return want if _msgpack is not None else "json"


def encode_record(doc: dict, codec: str = "binary") -> bytes:
    """One record doc -> payload bytes (no CRC frame).  Binary falls back
    to canonical JSON per-record when msgpack is missing or a value
    exceeds its integer range — the sniffing decoder makes the fallback
    free and lossless."""
    if codec == "binary" and _msgpack is not None:
        try:
            return _PREFIX + _msgpack.packb(doc)
        except (OverflowError, TypeError, ValueError):
            pass   # out-of-range int / exotic value: JSON carries it
    return json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode()


def decode_record(payload: bytes) -> dict:
    """Payload bytes -> record doc, sniffing the codec per record."""
    if len(payload) > 1 and payload[0] == MAGIC:
        version = payload[1]
        if version not in SUPPORTED_VERSIONS:
            raise RecordError(
                f"unsupported WAL record version {version} "
                f"(supported: {SUPPORTED_VERSIONS})")
        if _msgpack is None:   # pragma: no cover - image has msgpack
            raise RecordError(
                "binary WAL record but msgpack is unavailable")
        return _msgpack.unpackb(payload[2:])
    return json.loads(payload.decode())
