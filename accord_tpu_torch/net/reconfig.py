"""Elastic serving: live epoch reconfiguration on the TCP cluster.

The sim burn has churned topology epochs since the seed, but until this
module the serving cluster (``accord_tpu.net``) was frozen at spawn: no
node could ever join, no shard could move, no epoch could retire.  This
is the serving-side control plane that wires the EXISTING protocol
machinery — ``ConfigurationService`` epoch lifecycle,
``TopologyManager`` sync quorums, ``Bootstrap``'s ExclusiveSyncPoint +
``FetchSnapshot`` snapshot fetch (SURVEY §1, §2.9) — through the TCP
surface, instead of inventing a parallel one:

- an operator verb (``reconfigure`` on the control-verb path, driven by
  ``tools/reconfig.py``) proposes epoch N+1 — add a node, remove a node,
  or move a range — as a deterministic pure function of the current
  topology (:func:`plan_join` / :func:`plan_leave` / :func:`plan_move`,
  the same planners the burn's serving-shaped churn leg drives in sim);
- the new topology propagates as ``topo_new`` wire bodies (a plain
  JSON/msgpack doc carrying shard maps AND member addresses, so every
  receiver can dial nodes it has never met); each node ingests it
  through its :class:`NetConfigService` into the real
  ``Node.on_topology_update`` path — stores hand off ranges via the
  ``RangesForEpoch`` machinery, added ranges bootstrap over the wire
  (``FetchSnapshot``/``FetchSnapshotOk`` through the binary codec,
  chunk-streamed by ``net.bootstrap`` when the payload outgrows one
  frame), and the node fences + acks the epoch exactly as in sim;
- ``epoch_sync`` gossip carries the sync-quorum acks; once an epoch's
  successor is fully synced the old epoch RETIRES
  (``TopologyManager.retire_below``) and links to departed peers drain
  closed;
- the whole ledger is crash-durable when a journal is armed: the
  proposer journals the epoch doc BEFORE the first broadcast
  (``record_topology`` + a blocking flush), every ingester journals what
  it accepted, and recovery re-ingests the epoch history — kill -9
  mid-reconfiguration recovers into a consistent epoch.

Convergence is gossip-shaped and idempotent, the right fit for a
real-time cluster (the sim keeps its deterministic delivery): the
``codec_hello`` handshake now carries the sender's current epoch, so a
node that slept through a reconfiguration fetches the gap
(``topo_fetch`` → ``topo_new``) the moment any peer link re-forms; a
periodic tick re-gossips sync acks and retires what is settled.

Competing proposals for the same epoch are serialized by the operator
(the ``reconfigure`` verb REJECTS while the current epoch is unsynced or
any store is still bootstrapping — the same no-stacking guard the burn's
churn has always used); a conflicting doc for an epoch a node already
ingested is rejected loudly and counted, never silently adopted.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from ..impl.config_service import AbstractConfigurationService
from ..topology.shard import Shard
from ..topology.topology import Topology
from ..primitives.keys import Range

# keep the retiring epoch's PREDECESSOR around one generation: it is the
# donor catalogue for any bootstrap the newest epoch still runs
RETIRE_LAG = 1
# periodic convergence tick (re-gossip acks, retire settled epochs,
# watch bootstrap progress) — wall-clock serving cadence, not sim time
TICK_MICROS = 500_000


# ---------------------------------------------------------------------------
# epoch planners: pure, deterministic functions of (topology, op)
# ---------------------------------------------------------------------------

def _round_robin(members: List[int], shard_index: int, rf: int) -> List[int]:
    n = len(members)
    return [members[(shard_index + j) % n] for j in range(min(rf, n))]


def plan_join(topology: Topology, new_node: int,
              epoch: Optional[int] = None) -> Topology:
    """Epoch N+1 admitting ``new_node``: shard boundaries are preserved,
    replicas are re-dealt round-robin over the grown member list with each
    shard's replication degree kept — the same dealing rule the initial
    maelstrom topology uses, so repeated joins/leaves stay in one family
    of layouts (every displaced replica is a partial handoff the adopters
    bootstrap)."""
    if new_node in topology.nodes():
        raise ValueError(f"node {new_node} is already a member")
    members = sorted(topology.nodes() | {new_node})
    shards = [Shard(s.range, _round_robin(members, i, len(s.nodes)),
                    frozenset())
              for i, s in enumerate(topology.shards)]
    return Topology(epoch if epoch is not None else topology.epoch + 1,
                    shards)


def plan_leave(topology: Topology, node: int,
               epoch: Optional[int] = None) -> Topology:
    """Epoch N+1 retiring ``node``: same dealing rule over the shrunken
    member list; each shard keeps min(its rf, survivors) replicas."""
    if node not in topology.nodes():
        raise ValueError(f"node {node} is not a member")
    members = sorted(topology.nodes() - {node})
    if not members:
        raise ValueError("cannot remove the last member")
    shards = [Shard(s.range, _round_robin(members, i, len(s.nodes)),
                    frozenset())
              for i, s in enumerate(topology.shards)]
    return Topology(epoch if epoch is not None else topology.epoch + 1,
                    shards)


def plan_move(topology: Topology, token: int, to_node: int,
              epoch: Optional[int] = None) -> Topology:
    """Epoch N+1 moving the shard containing ``token`` onto ``to_node``:
    the shard's last replica not already equal to ``to_node`` is replaced
    (a single-range handoff — the minimal reconfiguration)."""
    if to_node not in topology.nodes():
        raise ValueError(f"move target {to_node} is not a member")
    shards = []
    moved = False
    for s in topology.shards:
        if not moved and s.contains_token(token):
            if to_node in s.nodes:
                # no-op move: the shard is untouched — keep its
                # electorate too (resetting it would silently widen the
                # fast path with zero data movement)
                shards.append(Shard(s.range, list(s.nodes),
                                    s.fast_path_electorate))
            else:
                nodes = list(s.nodes[:-1]) + [to_node]
                shards.append(Shard(s.range, nodes, frozenset()))
            moved = True
        else:
            shards.append(Shard(s.range, list(s.nodes),
                                s.fast_path_electorate))
    if not moved:
        raise ValueError(f"no shard contains token {token}")
    return Topology(epoch if epoch is not None else topology.epoch + 1,
                    shards)


# ---------------------------------------------------------------------------
# topology wire docs: plain JSON/msgpack-safe payloads (no wire._t tags —
# they ride control bodies AND journal records AND the CLI)
# ---------------------------------------------------------------------------

def topology_to_doc(topology: Topology,
                    nodes_info: Dict[int, Tuple[str, str, int]],
                    proposer: str = "") -> dict:
    """``nodes_info``: id -> (name, host, port) for every member (address
    book entries let receivers dial nodes they have never met)."""
    doc = {
        "epoch": topology.epoch,
        "shards": [[s.range.start, s.range.end, list(s.nodes),
                    sorted(s.fast_path_electorate)]
                   for s in topology.shards],
        "nodes": {str(nid): [name, host, port]
                  for nid, (name, host, port) in sorted(nodes_info.items())},
        "proposer": proposer,
    }
    return doc


def topology_from_doc(doc: dict) -> Topology:
    shards = [Shard(Range(start, end), list(nodes),
                    frozenset(electorate) if electorate else frozenset())
              for start, end, nodes, electorate in doc["shards"]]
    return Topology(doc["epoch"], shards)


def doc_nodes_info(doc: dict) -> Dict[int, Tuple[str, str, int]]:
    return {int(nid): (name, host, port)
            for nid, (name, host, port) in (doc.get("nodes") or {}).items()}


# ---------------------------------------------------------------------------
# the configuration service the serving node runs on
# ---------------------------------------------------------------------------

class NetConfigService(AbstractConfigurationService):
    """Epoch ledger over the wire: fetches ask peers (``topo_fetch``),
    acks gossip to peers (``epoch_sync``) — the concrete service the
    reference's AbstractConfigurationService seams expect, backed by the
    :class:`ReconfigManager`'s transport."""

    def __init__(self, manager: "ReconfigManager"):
        super().__init__()
        self.manager = manager

    def fetch_topology_for_epoch(self, epoch: int) -> None:
        self.manager.request_epoch(epoch)

    def acknowledge_epoch(self, epoch_ready, start_sync: bool = True) -> None:
        self.manager.broadcast_sync(epoch_ready.epoch)

    def known_epochs(self) -> List[Topology]:
        return list(self._epochs)


class ReconfigManager:
    """Per-node serving reconfiguration brain.

    Owns the epoch doc ledger (``_known``), the address book, the
    propose/ingest/gossip protocol, epoch retirement, dynamic peer-link
    lifecycle (dial-on-join, drain-on-leave) and the elastic serving
    counters.  Single-threaded on the server's asyncio loop."""

    def __init__(self, server):
        self.server = server                    # NodeServer
        self.config_service = NetConfigService(self)
        self.node = None                        # set by attach_node
        self._known: Dict[int, dict] = {}       # epoch -> doc
        self._acked: List[int] = []             # epochs we sync-acked
        self._draining = False
        # address book: name -> (host, port); ids: id -> name
        self.addr_book: Dict[str, Tuple[str, int]] = {}
        self.names_by_id: Dict[int, str] = {}
        # bootstrap watch (journal-independent: polls store.bootstrapping)
        self._boot_active_since: Optional[float] = None
        self.bootstrap_wall_ms = 0
        self.bootstraps_done = 0
        self.handoff_ranges = 0
        self.bootstrap_bytes_rx = 0
        # counters
        self.epochs_proposed = 0
        self.epochs_retired = 0
        self.topo_new_rx = 0
        self.topo_conflicts = 0
        self.epoch_syncs_rx = 0
        self.links_added = 0
        self.links_dropped = 0
        self._tick_handle = None
        self._last_ingest = 0.0   # monotonic time of the newest epoch
        self._peer_acks: set = set()            # (src, epoch) seen
        self._ack_reply_at: Dict[str, float] = {}   # anti-storm limiter
        self._replaying_history = False         # attach-time replay guard

    # -- identity helpers ---------------------------------------------------
    def _id_of(self, name: str) -> int:
        from ..maelstrom.node import node_name_to_id
        return node_name_to_id(name)

    def note_member(self, name: str, host: Optional[str] = None,
                    port: Optional[int] = None) -> None:
        nid = self._id_of(name)
        self.names_by_id[nid] = name
        if host is not None:
            self.addr_book[name] = (host, port)
        proc = getattr(self.server, "proc", None)
        if proc is not None:
            proc.note_peer(name)

    def _ingest_doc_nodes(self, doc: dict) -> None:
        for nid, (name, host, port) in doc_nodes_info(doc).items():
            self.note_member(name, host, port)

    def nodes_info(self, topology: Topology) -> Dict[int, Tuple[str, str, int]]:
        out = {}
        for nid in sorted(topology.nodes()):
            name = self.names_by_id.get(nid)
            if name is None:
                continue
            host, port = self.addr_book.get(name, (None, None))
            if host is None:
                if name == self.server.name:
                    host, port = self.server.host, self.server.port
                else:
                    continue
            out[nid] = (name, host, port)
        return out

    # -- boot / attach ------------------------------------------------------
    def load_journal_epochs(self, journal) -> None:
        """Pre-init: pull the journaled epoch ledger (kill -9 recovery —
        incl. a proposal journaled but never broadcast)."""
        if journal is None or not hasattr(journal, "topologies"):
            return
        for doc in journal.topologies():
            self._known[doc["epoch"]] = doc
            self._ingest_doc_nodes(doc)

    def bootstrap_topologies(self, epoch1: Topology) -> List[Topology]:
        """The contiguous epoch history this node starts from: the static
        epoch-1 topology plus every journaled successor.  Also feeds the
        config service's ledger (before the node registers as listener)."""
        topos = [topology_from_doc(self._known[1])
                 if 1 in self._known else epoch1]
        e = 2
        while e in self._known:
            topos.append(topology_from_doc(self._known[e]))
            e += 1
        for t in topos:
            self.config_service.report_topology(t)
        return topos

    def attach_node(self, node) -> None:
        """Called once the Node exists and holds its initial epoch
        history: future epochs flow through the config service listener
        path; the convergence tick starts."""
        self.node = node
        my_id = self._id_of(self.server.name)
        # the listener replays the known history at registration — that
        # replay must not re-count historical handoffs or start a bogus
        # bootstrap clock (a recovered joiner already DID that work)
        self._replaying_history = True
        try:
            self.config_service.register_listener(self._on_epoch_ingested)
        finally:
            self._replaying_history = False
        for t in self.config_service.known_epochs():
            # recovered epochs: re-ack what a previous incarnation synced
            # — both OUTBOUND (gossip) and into our own TopologyManager
            # (restore_topologies acked only the latest locally; a middle
            # epoch whose shard quorum needs this node could otherwise
            # never re-reach sync_complete here)
            if t.epoch not in self._acked:
                self._acked.append(t.epoch)
            node.topology_manager.on_epoch_sync_complete(my_id, t.epoch)
        self.server.refresh_hello()
        scheduler = getattr(self.server.proc, "scheduler", None)
        if scheduler is not None:
            self._tick_handle = scheduler.recurring(TICK_MICROS, self.tick)

    # -- listener: every ingested epoch -------------------------------------
    def _on_epoch_ingested(self, topology: Topology) -> None:
        """Config-service listener: runs for every epoch the ledger
        accepts (including the replayed history at registration)."""
        if topology.epoch not in self._known:
            self._known[topology.epoch] = topology_to_doc(
                topology, self.nodes_info(topology), self.server.name)
        # dial-on-join: ensure outbound links to every member we can
        # address; count handoff ranges granted to US by this epoch
        my_id = self._id_of(self.server.name)
        for nid in sorted(topology.nodes()):
            name = self.names_by_id.get(nid)
            if name is None or name == self.server.name:
                continue
            addr = self.addr_book.get(name)
            if addr is not None and self.server.ensure_link(name, *addr):
                self.links_added += 1
        prev = self.config_service.get_topology_for_epoch(topology.epoch - 1)
        if prev is not None and not self._replaying_history:
            gained = topology.ranges_for_node(my_id).without(
                prev.ranges_for_node(my_id))
            n_gained = len(list(gained))
            self.handoff_ranges += n_gained
            if n_gained and self._boot_active_since is None:
                # the rebalance clock starts at ingest (event-driven: the
                # store's Bootstrap begins right after this listener);
                # the tick closes it when every store's bootstrapping
                # set empties — wall resolution is one tick
                self._boot_active_since = time.monotonic()
        self._last_ingest = time.monotonic()
        self._draining = my_id not in topology.nodes()
        self.server.refresh_hello()

    # -- outbound gossip -----------------------------------------------------
    def _send(self, name: str, body: dict) -> None:
        if name == self.server.name:
            return
        addr = self.addr_book.get(name)
        if addr is not None:
            self.server.ensure_link(name, *addr)
        if name in self.server.links:
            self.server._emit(name, dict(body))

    def broadcast_sync(self, epoch: int) -> None:
        if epoch not in self._acked:
            self._acked.append(epoch)
        body = {"type": "epoch_sync", "node": self.server.name,
                "epoch": epoch}
        for name in self._gossip_targets():
            self._send(name, body)

    def request_epoch(self, epoch: int) -> None:
        body = {"type": "topo_fetch", "node": self.server.name,
                "epoch": epoch}
        for name in self._gossip_targets():
            self._send(name, body)

    def _gossip_targets(self) -> List[str]:
        """Peers the sync/fetch gossip addresses: members of the
        RETAINED epochs (departed nodes whose epochs retired are no
        longer re-dialed — their docs stay in ``_known`` only to answer
        topo_fetch), falling back to the live link set pre-attach."""
        names = set(self.server.links)
        tm = self.node.topology_manager if self.node is not None else None
        if tm is not None and tm.epoch():
            for e in range(tm.min_epoch(), tm.epoch() + 1):
                if tm.has_epoch(e):
                    for nid in tm.get_topology_for_epoch(e).nodes():
                        n = self.names_by_id.get(nid)
                        if n is not None:
                            names.add(n)
        else:
            for doc in self._known.values():
                for _nid, (name, _h, _p) in doc_nodes_info(doc).items():
                    names.add(name)
        names.discard(self.server.name)
        return sorted(names)

    def _broadcast_doc(self, doc: dict, also: Tuple[str, ...] = ()) -> None:
        body = {"type": "topo_new", "topology": doc}
        targets = set(self._gossip_targets()) | set(also)
        targets.discard(self.server.name)
        for name in sorted(targets):
            self._send(name, body)

    # -- the operator verb ---------------------------------------------------
    def propose(self, body: dict) -> dict:
        """Handle one ``reconfigure`` control body; returns the reply
        body.  Ops: add (node+addr), remove (node), move (token+node).
        The proposal is journaled durable BEFORE the first broadcast, so
        a proposer killed -9 mid-propose recovers holding (and
        re-gossiping) the epoch it minted."""
        node = self.node
        if node is None:
            return {"type": "error", "code": 11, "text": "node not ready"}
        tm = node.topology_manager
        current = tm.current()
        # no-stacking guard: require EVERY member's ack for the current
        # epoch (stronger than the per-shard quorum sync_complete closes
        # on — a quorum settles while a mover/joiner is still fencing),
        # plus no local rebalance in flight.  This is still a
        # proposer-local view: bootstrap progress on OTHER nodes is not
        # cluster-visible, so operators serialize proposals (ROADMAP
        # folds the metadata-consensus proposer into the multi-box
        # thread) — the guard narrows the race, the operator closes it.
        if not tm.all_members_synced(current.epoch):
            return {"type": "error", "code": 11,
                    "text": f"epoch {current.epoch} still syncing; "
                            f"retry when settled"}
        if any(not s.bootstrapping.is_empty()
               for s in node.command_stores.stores):
            return {"type": "error", "code": 11,
                    "text": "rebalance in progress; retry when settled"}
        op = body.get("op")
        try:
            if op == "add":
                name = body["node"]
                host, _, port = str(body["addr"]).rpartition(":")
                self.note_member(name, host or "127.0.0.1", int(port))
                topo = plan_join(current, self._id_of(name))
            elif op == "remove":
                name = body["node"]
                topo = plan_leave(current, self._id_of(name))
            elif op == "move":
                name = body["node"]
                topo = plan_move(current, int(body["token"]),
                                 self._id_of(name))
            else:
                return {"type": "error", "code": 10,
                        "text": f"unknown reconfigure op {op!r}"}
        except (KeyError, ValueError, TypeError) as exc:
            return {"type": "error", "code": 10, "text": repr(exc)}
        doc = topology_to_doc(topo, self.nodes_info(topo), self.server.name)
        journal = self.server.journal
        if journal is not None and hasattr(journal, "record_topology"):
            # durable-before-broadcast: the epoch must survive our own
            # kill -9 once any peer may have seen it.  A journal that
            # CANNOT make that promise (degraded group commit, failing
            # flush) aborts the proposal loudly — the operator proposes
            # through a healthy node instead; broadcasting an epoch the
            # proposer might forget is exactly the lost/forked-epoch
            # hazard this write exists to prevent.
            commit = getattr(journal, "commit", None)
            if commit is not None and commit.failed:
                return {"type": "error", "code": 11,
                        "text": "journal degraded: cannot make the "
                                "epoch durable; propose via another node"}
            journal.record_topology(doc)
            if commit is not None:
                try:
                    commit.flush(sync=True)
                except Exception as exc:
                    return {"type": "error", "code": 11,
                            "text": f"journal flush failed ({exc!r}); "
                                    f"proposal aborted"}
            if os.environ.get("ACCORD_TPU_RECONFIG_CRASH") == "after-flush":
                # deterministic crash point for the fault-matrix
                # mid-propose leg: die holding a journaled epoch NO peer
                # has ever seen — recovery must re-ingest it and the
                # hello-epoch gossip must propagate it, or the epoch is
                # lost (the exact window durable-before-broadcast exists
                # for).  _exit: no close(), no final flush — a kill -9.
                os._exit(137)
        self.epochs_proposed += 1
        # previous membership must hear the epoch that removes them —
        # broadcast to old ∪ new members
        also = tuple(self.names_by_id.get(nid, "")
                     for nid in current.nodes() | topo.nodes())
        self.on_topo_new(doc, from_src=self.server.name)
        self._broadcast_doc(doc, also=tuple(n for n in also if n))
        return {"type": "reconfigure_ok", "epoch": topo.epoch,
                "topology": doc}

    # -- inbound verbs --------------------------------------------------------
    def on_topo_new(self, doc: dict, from_src: str = "") -> None:
        try:
            epoch = int(doc["epoch"])
            topo = topology_from_doc(doc)
        except Exception as exc:
            print(f"[{self.server.name}] bad topo_new from {from_src}: "
                  f"{exc!r}", file=sys.stderr)
            return
        known = self._known.get(epoch)
        if known is not None:
            if known.get("shards") != doc.get("shards"):
                # competing proposal for an epoch we already hold:
                # first-wins per node, surfaced loudly (the reconfigure
                # verb's no-stacking guard makes this operator error)
                self.topo_conflicts += 1
                print(f"[{self.server.name}] CONFLICTING topology for "
                      f"epoch {epoch} from {from_src} rejected "
                      f"(first-wins)", file=sys.stderr)
            return
        self.topo_new_rx += 1
        self._known[epoch] = doc
        self._ingest_doc_nodes(doc)
        journal = self.server.journal
        if journal is not None and hasattr(journal, "record_topology"):
            journal.record_topology(doc)
        # feed the config service CONTIGUOUSLY (its ledger asserts it);
        # fetch any gap from peers
        self._drain_known()

    def _drain_known(self) -> None:
        cs = self.config_service
        while True:
            have = cs.known_epochs()
            nxt = (have[-1].epoch + 1) if have else 1
            doc = self._known.get(nxt)
            if doc is None:
                if self._known and max(self._known) >= nxt:
                    self.request_epoch(nxt)
                return
            cs.report_topology(topology_from_doc(doc))
            if self.node is not None and not self.node.topology_manager \
                    .has_epoch(nxt):
                self.node.on_topology_update(
                    cs.get_topology_for_epoch(nxt))
                # the hello must announce the epoch the NODE now holds —
                # the listener above ran before the node ingested it, so
                # its refresh saw the previous epoch
                self.server.refresh_hello()

    def on_epoch_sync(self, src_name: str, epoch: int) -> None:
        self.epoch_syncs_rx += 1
        if self.node is None:
            return
        if not self.node.topology_manager.has_epoch(epoch) \
                and epoch > self.node.topology_manager.epoch():
            # gossip about an epoch we never saw: fetch it
            self.request_epoch(epoch)
        if (src_name, epoch) in self._peer_acks:
            # a DUPLICATE ack means the sender is still re-gossiping —
            # i.e. its own quorums are unsettled, possibly because it is
            # missing OUR acks (we may have gone quiet after settling).
            # Answer with our ack set, rate-limited per peer, so two
            # nodes can never deadlock each other into silence.
            now = time.monotonic()
            if now - self._ack_reply_at.get(src_name, 0.0) > 1.0:
                self._ack_reply_at[src_name] = now
                for e in self._acked[-4:]:
                    self._send(src_name, {"type": "epoch_sync",
                                          "node": self.server.name,
                                          "epoch": e})
        else:
            self._peer_acks.add((src_name, epoch))
        self.node.topology_manager.on_epoch_sync_complete(
            self._id_of(src_name), epoch)

    def on_topo_fetch(self, src_name: str, epoch: int) -> None:
        doc = self._known.get(epoch)
        if doc is not None:
            self._send(src_name, {"type": "topo_new", "topology": doc})

    def on_peer_hello(self, src_name: str, body: dict) -> None:
        """codec_hello now carries the sender's epoch: a peer ahead of us
        is the catch-up trigger (they reconfigured while we slept), a
        peer behind us gets our ack gossip so their quorums settle."""
        peer_epoch = body.get("epoch")
        if peer_epoch is None or self.node is None:
            return
        mine = self.node.topology_manager.epoch()
        if peer_epoch > mine:
            self.request_epoch(mine + 1)
        elif peer_epoch < mine:
            doc = self._known.get(peer_epoch + 1)
            if doc is not None:
                self._send(src_name, {"type": "topo_new", "topology": doc})
        for e in self._acked[-4:]:   # recent window, like the tick's
            self._send(src_name, {"type": "epoch_sync",
                                  "node": self.server.name, "epoch": e})

    # -- the convergence tick -------------------------------------------------
    def tick(self) -> None:
        node = self.node
        if node is None:
            return
        tm = node.topology_manager
        # 1. re-gossip acks while any known epoch is not yet fully synced
        #    OR an epoch arrived recently (idempotent; the grace window
        #    covers the asymmetric case where OUR ledger is settled but a
        #    late joiner still needs our ack to close its quorums)
        if (time.monotonic() - self._last_ingest) < 10.0 \
                or any(not tm.is_sync_complete(e)
                       for e in range(tm.min_epoch(), tm.epoch() + 1)
                       if tm.has_epoch(e)):
            for e in self._acked[-4:]:
                self.broadcast_sync(e)
        # 2. bootstrap watch: wall clock + completion census
        booting = any(not s.bootstrapping.is_empty()
                      for s in node.command_stores.stores)
        if booting and self._boot_active_since is None:
            self._boot_active_since = time.monotonic()
        elif not booting and self._boot_active_since is not None:
            self.bootstrap_wall_ms += int(
                (time.monotonic() - self._boot_active_since) * 1000)
            self._boot_active_since = None
            self.bootstraps_done += 1
        # 3. retirement: epochs strictly below the newest prefix-synced
        #    epoch minus RETIRE_LAG retire (the lag keeps the bootstrap
        #    donor catalogue alive one generation); never retire while a
        #    bootstrap is in flight
        if not booting:
            synced_prefix = None
            for e in range(tm.min_epoch(), tm.epoch() + 1):
                if tm.has_epoch(e) and tm.is_sync_complete(e):
                    synced_prefix = e
                else:
                    break
            if synced_prefix is not None:
                n = tm.retire_below(synced_prefix - RETIRE_LAG)
                if n:
                    self.epochs_retired += n
                    # prune gossip state the retired epochs carried (a
                    # long-lived cluster must not grow these forever)
                    floor = tm.min_epoch()
                    self._acked = [e for e in self._acked if e >= floor]
                    self._peer_acks = {(s, e) for s, e in self._peer_acks
                                       if e >= floor}
            if synced_prefix == tm.epoch():
                # current epoch settled with no rebalance in flight: the
                # donor catalogue is no longer needed, so links to peers
                # outside the CURRENT membership drain closed
                self._drop_departed_links(tm.current().nodes())

    def _drop_departed_links(self, live) -> None:
        """drain-on-leave: close links to peers outside ``live``."""
        live_names = {self.names_by_id.get(nid) for nid in live}
        for name in sorted(set(self.server.links) - live_names):
            self.server.drop_link(name)
            self.links_dropped += 1

    def note_snapshot_reply(self, body: dict) -> None:
        """Weigh one FetchSnapshotOk that rode a batch envelope (the one
        delivery shape the frame layer cannot size).  Envelope riders
        are small by construction — payloads over CHUNK_THRESHOLD always
        leave as direct or chunked frames and are counted for free from
        their frame lengths — so this re-encode is cheap and rare."""
        try:
            import msgpack
            n = len(msgpack.packb(body))
        except Exception:
            import json
            try:
                n = len(json.dumps(body))
            except (TypeError, ValueError):
                n = 0
        self.bootstrap_bytes_rx += n

    # -- surface ---------------------------------------------------------------
    def stats(self) -> dict:
        node = self.node
        tm = node.topology_manager if node is not None else None
        return {
            "epoch_current": tm.epoch() if tm else 0,
            "epoch_min": tm.min_epoch() if tm else 0,
            "epochs_known": sorted(self._known),
            "epochs_retired": self.epochs_retired,
            "epochs_proposed": self.epochs_proposed,
            "epoch_synced": (tm.is_sync_complete(tm.epoch())
                             if tm and tm.epoch() else False),
            "topo_new_rx": self.topo_new_rx,
            "topo_conflicts": self.topo_conflicts,
            "epoch_syncs_rx": self.epoch_syncs_rx,
            "bootstrap_bytes_rx": self.bootstrap_bytes_rx,
            "bootstrap_wall_ms": self.bootstrap_wall_ms,
            "bootstraps_done": self.bootstraps_done,
            "bootstrapping_now": (
                any(not s.bootstrapping.is_empty()
                    for s in node.command_stores.stores)
                if node is not None else False),
            "handoff_ranges": self.handoff_ranges,
            "links_added": self.links_added,
            "links_dropped": self.links_dropped,
            "draining": self._draining,
        }
