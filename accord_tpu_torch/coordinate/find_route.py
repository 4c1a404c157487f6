"""Route discovery probes.

Rebuild of ref: accord-core/src/main/java/accord/coordinate/FindRoute.java,
FindSomeRoute.java, CheckShards.java and messages/InformHomeOfTxn — when a
node learns a TxnId without its route (a bare dep, a gossiped id), these
probes walk replicas asking CheckStatus(Route) until someone supplies it,
so recovery and fetches no longer assume the caller knows the route.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from .. import api
from ..messages.check_status import CheckStatus, CheckStatusOk, IncludeInfo
from ..primitives.keys import Range, Ranges, RoutingKeys
from ..primitives.timestamp import TxnId
from ..utils import async_chain
from .errors import Exhausted

# the probe scans every store of the asked replica: the asker has no idea
# where the txn participates — that is the point of the probe
_FULL_SPACE = Ranges.of(Range(-(1 << 62), 1 << 62))


def find_route(node, txn_id: TxnId, hint_participants
               ) -> async_chain.AsyncChain:
    """Probe replicas of ``hint_participants`` (falling back to the whole
    cluster — the CheckShards sweep) for a FULL route (with home key).
    Settles with the Route or None if nobody knows it
    (ref: coordinate/FindRoute.java)."""
    return _probe(node, txn_id, hint_participants, full=True)


def find_some_route(node, txn_id: TxnId, hint_participants
                    ) -> async_chain.AsyncChain:
    """Like find_route but any partial route satisfies
    (ref: coordinate/FindSomeRoute.java)."""
    return _probe(node, txn_id, hint_participants, full=False)


def inform_home_of_txn(node, txn_id: TxnId, route) -> None:
    """Tell the home shard's replicas to track (and so recover) the txn
    (ref: messages/InformHomeOfTxn.java)."""
    from ..messages.inform import InformOfTxnId
    if route is None or route.home_key is None:
        return
    home = RoutingKeys.of(route.home_key)
    topologies = node.topology().for_epoch(home, txn_id.epoch())
    request = InformOfTxnId(txn_id, route)
    for to in sorted(topologies.nodes()):
        node.send(to, request)


def _candidates(node, txn_id: TxnId, hint_participants) -> List[int]:
    """Replicas of the hint first (most likely to know), then every other
    cluster node (the CheckShards sweep over all shards)."""
    out: List[int] = []
    epoch = min(txn_id.epoch(), node.epoch())
    if hint_participants is not None and not hint_participants.is_empty():
        try:
            for n in sorted(node.topology().for_epoch(
                    hint_participants, epoch).nodes()):
                if n not in out:
                    out.append(n)
        except Exception:
            pass
    for n in sorted(node.topology().current().nodes()):
        if n not in out:
            out.append(n)
    return out


def _probe(node, txn_id: TxnId, hint_participants,
           full: bool) -> async_chain.AsyncChain:
    result: async_chain.AsyncResult = async_chain.AsyncResult()
    candidates = _candidates(node, txn_id, hint_participants)
    epoch = min(txn_id.epoch(), node.epoch())
    state = {"merged": None, "done": False}

    def satisfied(route) -> bool:
        if route is None:
            return False
        return route.home_key is not None if full else True

    def ask(remaining: List[int]) -> None:
        if state["done"]:
            return
        if not remaining:
            state["done"] = True
            # settle with the best partial knowledge (or None)
            merged = state["merged"]
            result.set_success(merged.route if merged is not None else None)
            return
        to, rest = remaining[0], remaining[1:]

        class Cb(api.Callback):
            def on_success(self, from_id: int, reply) -> None:
                if state["done"]:
                    return
                if isinstance(reply, CheckStatusOk):
                    state["merged"] = (reply if state["merged"] is None
                                       else state["merged"].merge(reply))
                    merged = state["merged"]
                    if satisfied(merged.route):
                        state["done"] = True
                        result.set_success(merged.route)
                        return
                ask(rest)

            def on_failure(self, from_id: int, failure: BaseException) -> None:
                if not state["done"]:
                    ask(rest)

        node.send(to, CheckStatus(txn_id, _FULL_SPACE, epoch,
                                  IncludeInfo.Route), Cb())

    ask(candidates)
    return result
