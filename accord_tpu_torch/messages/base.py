"""Message plumbing: Request/Reply bases, MessageType registry.

Rebuild of ref: accord-core/src/main/java/accord/messages/TxnRequest.java:42-130,
MessageType.java:34-116, Callback.java, Reply.java.

Unlike the reference (which slices a per-destination ``scope`` on the
coordinator to save bandwidth), requests here carry the full route and each
replica slices to its owned ranges on receipt — same behaviour, simpler wire
contract; the simulator and maelstrom adapter serialize these objects whole.
"""

from __future__ import annotations

import enum
from typing import Optional

from ..primitives.keys import Route
from ..primitives.timestamp import TxnId


class MessageType(enum.Enum):
    """Verb registry (ref: messages/MessageType.java:34-116).
    has_side_effects drives journal persistence.  Values must be UNIQUE
    (id, has_side_effects) pairs: Python enums alias equal values, and an
    aliased registry breaks any dispatch on the member identity (the journal
    switches on it)."""

    SIMPLE_RSP = (0, False)
    FAILURE_RSP = (1, False)
    PRE_ACCEPT_REQ = (2, True)
    PRE_ACCEPT_RSP = (3, False)
    ACCEPT_REQ = (4, True)
    ACCEPT_RSP = (5, False)
    ACCEPT_INVALIDATE_REQ = (6, True)
    ACCEPT_INVALIDATE_RSP = (7, False)
    GET_DEPS_REQ = (8, False)
    GET_DEPS_RSP = (9, False)
    GET_EPHEMERAL_READ_DEPS_REQ = (10, False)
    GET_EPHEMERAL_READ_DEPS_RSP = (11, False)
    GET_MAX_CONFLICT_REQ = (12, False)
    GET_MAX_CONFLICT_RSP = (13, False)
    COMMIT_SLOW_PATH_REQ = (14, True)
    COMMIT_MAXIMAL_REQ = (15, True)
    STABLE_FAST_PATH_REQ = (16, True)
    STABLE_SLOW_PATH_REQ = (17, True)
    STABLE_MAXIMAL_REQ = (18, True)
    COMMIT_INVALIDATE_REQ = (19, True)
    APPLY_MINIMAL_REQ = (20, True)
    APPLY_MAXIMAL_REQ = (21, True)
    APPLY_RSP = (22, False)
    READ_REQ = (23, False)
    READ_EPHEMERAL_REQ = (24, False)
    READ_RSP = (25, False)
    BEGIN_RECOVER_REQ = (26, True)
    BEGIN_RECOVER_RSP = (27, False)
    BEGIN_INVALIDATE_REQ = (28, True)
    BEGIN_INVALIDATE_RSP = (29, False)
    WAIT_ON_COMMIT_REQ = (30, False)
    WAIT_ON_COMMIT_RSP = (31, False)
    WAIT_UNTIL_APPLIED_REQ = (32, False)
    APPLY_THEN_WAIT_UNTIL_APPLIED_REQ = (33, True)
    INFORM_OF_TXN_REQ = (34, True)
    INFORM_DURABLE_REQ = (35, True)
    INFORM_HOME_DURABLE_REQ = (36, True)
    CHECK_STATUS_REQ = (37, False)
    CHECK_STATUS_RSP = (38, False)
    FETCH_DATA_REQ = (39, False)
    FETCH_DATA_RSP = (40, False)
    SET_SHARD_DURABLE_REQ = (41, True)
    SET_GLOBALLY_DURABLE_REQ = (42, True)
    QUERY_DURABLE_BEFORE_REQ = (43, False)
    QUERY_DURABLE_BEFORE_RSP = (44, False)
    PROPAGATE_PRE_ACCEPT_MSG = (45, True)
    PROPAGATE_STABLE_MSG = (46, True)
    PROPAGATE_APPLY_MSG = (47, True)
    PROPAGATE_OTHER_MSG = (48, True)

    def __init__(self, _id: int, has_side_effects: bool):
        self.has_side_effects = has_side_effects


class Request:
    """Base request: processed on the replica (ref: messages/Request.java)."""

    type: MessageType = MessageType.SIMPLE_RSP
    wait_for_epoch: int = 0

    def process(self, node, from_id: int, reply_context) -> None:
        raise NotImplementedError


class Reply:
    """(ref: messages/Reply.java)."""

    type: MessageType = MessageType.SIMPLE_RSP

    def is_final(self) -> bool:
        return True


class FailureReply(Reply):
    type = MessageType.FAILURE_RSP

    def __init__(self, failure: BaseException):
        self.failure = failure

    def __repr__(self):
        return f"FailureReply({self.failure!r})"


class TxnRequest(Request):
    """A request about one txn addressed to the replicas of its route
    (ref: messages/TxnRequest.java).  wait_for_epoch gates processing until
    the replica knows the epoch."""

    def __init__(self, txn_id: TxnId, route: Route, wait_for_epoch: int):
        self.txn_id = txn_id
        self.route = route
        self.wait_for_epoch = wait_for_epoch

    def __repr__(self):
        return f"{type(self).__name__}({self.txn_id})"
