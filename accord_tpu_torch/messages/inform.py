"""Durability gossip verbs.

Rebuild of ref: accord-core/src/main/java/accord/messages/InformDurable.java,
InformOfTxnId.java — after a persist quorum the coordinator tells every
replica the txn is majority-durable; replicas record it (gating truncation)
and the home shard's progress log stands down.
"""

from __future__ import annotations

from ..local import commands
from ..local.command_store import PreLoadContext, SafeCommandStore
from ..local.status import Durability
from ..primitives.keys import Route
from ..primitives.timestamp import TxnId
from .base import MessageType, Reply, TxnRequest


class InformDurable(TxnRequest):
    """(ref: messages/InformDurable.java)."""

    type = MessageType.INFORM_DURABLE_REQ

    def __init__(self, txn_id: TxnId, route: Route, durability: Durability):
        super().__init__(txn_id, route, txn_id.epoch())
        self.durability = durability

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id, durability = self.txn_id, self.durability

        def apply_fn(safe: SafeCommandStore):
            commands.set_durability(safe, txn_id, durability)

        node.for_each_local(PreLoadContext.for_txn(txn_id),
                            self.route.participants,
                            txn_id.epoch(), txn_id.epoch(), apply_fn)


class InformHomeDurable(TxnRequest):
    """Tell the HOME shard a txn is durable (ref: messages/
    InformHomeDurable.java): the home progress log stands down without
    waiting to observe the durability itself — used when a fetch discovers
    remotely-established durability the home's InformDurable may have
    missed."""

    type = MessageType.INFORM_HOME_DURABLE_REQ

    def __init__(self, txn_id: TxnId, route: Route, execute_at,
                 durability: Durability):
        super().__init__(txn_id, route, txn_id.epoch())
        self.execute_at = execute_at
        self.durability = durability

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id, durability = self.txn_id, self.durability
        home_key = self.route.home_key
        if home_key is None:
            return

        def apply_fn(safe: SafeCommandStore):
            from ..local.status import Status
            cmd = safe.if_present(txn_id)
            if cmd is not None and cmd.is_truncated():
                return
            if self.execute_at is not None and cmd is not None \
                    and not cmd.has_been(Status.PreCommitted):
                # the ref's setDurability also installs the executeAt when
                # the home copy hasn't decided it yet
                commands.precommit(safe, txn_id, self.execute_at)
            commands.set_durability(safe, txn_id, durability)

        from ..primitives.keys import Ranges
        node.for_each_local(PreLoadContext.for_txn(txn_id),
                            Ranges.of(self.route.home_as_range()),
                            txn_id.epoch(), txn_id.epoch(), apply_fn)


class InformOfTxnId(TxnRequest):
    """Gossip a txn's existence to its home shard so the progress log there
    starts tracking it (ref: messages/InformOfTxnId.java)."""

    type = MessageType.INFORM_OF_TXN_REQ

    def __init__(self, txn_id: TxnId, route: Route):
        super().__init__(txn_id, route, txn_id.epoch())

    def process(self, node, from_id: int, reply_context) -> None:
        txn_id, route = self.txn_id, self.route

        def apply_fn(safe: SafeCommandStore):
            cmd = safe.get(txn_id)
            if cmd.route is None:
                safe.update(cmd.updated(route=route), notify=False)
            safe.progress_log().unwitnessed(safe, txn_id)

        node.for_each_local(PreLoadContext.for_txn(txn_id), route.participants,
                            txn_id.epoch(), txn_id.epoch(), apply_fn)
