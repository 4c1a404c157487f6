"""Multi-type Maelstrom datum values (reference parity, ROADMAP item 5).

The reference's Maelstrom workload carries four datum kinds
(ref: accord-maelstrom/src/main/java/accord/maelstrom/Datum.java —
Kind {STRING, LONG, DOUBLE, HASH}); until r12 this port's list-append
values were ints only.  String/long/double map onto native JSON scalars
(Python ints are arbitrary-precision, so 64-bit longs survive the JSON
boundary exactly); HASH is the one kind JSON cannot express natively, so
it travels as ``{"hash": <int>}`` on the Maelstrom client boundary and as
a tagged wire document (``accord_tpu.wire``, tag ``DHash``) inside
inter-node protocol bodies.

:class:`DatumHash` is hashable and totally ordered against itself so it
composes with the verifier's tuple equality and the store's value logs.
"""

from __future__ import annotations


class DatumHash:
    """The HASH datum kind: an opaque integer digest value."""

    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = int(value)

    def __eq__(self, other) -> bool:
        return isinstance(other, DatumHash) and other.value == self.value

    def __hash__(self) -> int:
        return hash(("DatumHash", self.value))

    def __lt__(self, other) -> bool:
        if not isinstance(other, DatumHash):
            return NotImplemented
        return self.value < other.value

    def __repr__(self) -> str:
        return f"DatumHash({self.value})"


def datum_from_json(v):
    """One Maelstrom client-boundary JSON value -> internal datum.
    Scalars (str/int/float/bool/None) pass through; ``{"hash": n}``
    becomes :class:`DatumHash`."""
    if isinstance(v, dict) and set(v) == {"hash"}:
        return DatumHash(v["hash"])
    return v


def datum_to_json(v):
    """Internal datum -> Maelstrom client-boundary JSON value."""
    if isinstance(v, DatumHash):
        return {"hash": v.value}
    return v
