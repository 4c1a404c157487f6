"""Assertion layer with global PARANOID/DEBUG gates.

TPU-native rebuild of the reference's invariant checking
(ref: accord-core/src/main/java/accord/utils/Invariants.java:31-40): deep
structural checks are gated behind module-level flags so the simulator can run
with full paranoia while benchmarks run without.
"""

from __future__ import annotations

PARANOID = True
DEBUG = True


class InvariantError(AssertionError):
    pass


def check_state(condition: bool, msg: str = "", *args) -> None:
    if not condition:
        raise InvariantError(msg % args if args else msg)


def check_argument(condition: bool, msg: str = "", *args) -> None:
    if not condition:
        raise InvariantError(msg % args if args else msg)


def illegal_state(msg: str = "", *args):
    raise InvariantError(msg % args if args else msg)


def illegal_argument(msg: str = "", *args):
    raise InvariantError(msg % args if args else msg)


def non_null(value, msg: str = "unexpected null"):
    if value is None:
        raise InvariantError(msg)
    return value


def paranoid(condition_fn) -> None:
    """Run an expensive structural check only when PARANOID is set."""
    if PARANOID:
        check_state(condition_fn())
