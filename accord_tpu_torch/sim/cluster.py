"""Deterministic in-process cluster: discrete-event simulation.

Rebuild of ref: accord-core/src/test/java/accord/impl/basic/Cluster.java:102,
NodeSink.java:46, RandomDelayQueue.java, PendingQueue.java.  One seeded
RandomSource drives simulated time, per-link latency, delivery actions
(DELIVER / DROP / DELIVER_WITH_FAILURE / FAILURE) and partitions — the whole
distributed system is a pure function of (seed, workload).
"""

from __future__ import annotations

import enum
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .. import api
from ..local.node import Node
from ..topology.topology import Topology
from ..utils import async_chain
from ..utils.random_source import RandomSource


class Action(enum.Enum):
    """(ref: impl/basic/NodeSink.java:46)."""
    DELIVER = 0
    DROP = 1
    DELIVER_WITH_FAILURE = 2   # deliver, but report failure to the sender
    FAILURE = 3                # don't deliver, report failure


class PendingQueue:
    """Simulated-time priority queue (ref: impl/basic/PendingQueue.java)."""

    def __init__(self):
        self._heap: List[List] = []
        self._seq = itertools.count()
        self.now = 0

    def add(self, at_micros: int, fn: Callable[[], None]) -> List:
        """Schedule ``fn``; the returned entry is a cancellation handle for
        ``cancel`` (entries are [at, seq, fn] lists — seq is unique, so
        heap ordering never compares the callables)."""
        entry = [max(at_micros, self.now), next(self._seq), fn]
        heapq.heappush(self._heap, entry)
        return entry

    @staticmethod
    def cancel(entry: List) -> None:
        """Tombstone a pending entry in place: pop() and is_empty() skip
        it, so a cancelled timeout costs one heap slot, not a live
        callback held for its full horizon."""
        entry[2] = None

    def pop(self) -> Optional[Callable[[], None]]:
        while self._heap:
            at, seq, fn = heapq.heappop(self._heap)
            if fn is None:
                continue
            self.now = max(self.now, at)
            return fn
        return None

    def is_empty(self) -> bool:
        return not any(fn is not None for _, _, fn in self._heap)


class _Scheduled(api.Scheduled):
    def __init__(self):
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def is_cancelled(self) -> bool:
        return self.cancelled


class SimScheduler(api.Scheduler):
    """(ref: the simulated Scheduler in impl/basic)."""

    def __init__(self, queue: PendingQueue):
        self.queue = queue

    def now(self, run: Callable[[], None]) -> None:
        self.queue.add(self.queue.now, run)

    def once(self, delay_micros: int, run: Callable[[], None]) -> api.Scheduled:
        handle = _Scheduled()

        def fire():
            if not handle.cancelled:
                run()
        self.queue.add(self.queue.now + delay_micros, fire)
        return handle

    def recurring(self, interval_micros: int, run: Callable[[], None]) -> api.Scheduled:
        handle = _Scheduled()

        def fire():
            if handle.cancelled:
                return
            run()
            self.queue.add(self.queue.now + interval_micros, fire)
        self.queue.add(self.queue.now + interval_micros, fire)
        return handle


class _ReplyContext:
    __slots__ = ("reply_to", "callback_id")

    def __init__(self, reply_to: int, callback_id: int):
        self.reply_to = reply_to
        self.callback_id = callback_id


class NodeSink(api.MessageSink):
    """Simulated network out for one node (ref: impl/basic/NodeSink.java)."""

    def __init__(self, node_id: int, cluster: "Cluster"):
        self.node_id = node_id
        self.cluster = cluster
        # set on restart: this incarnation's process died — everything it
        # still tries to send is a ghost and is silently dropped
        self.dead = False
        self._callbacks: Dict[int, api.Callback] = {}
        self._callback_seq = itertools.count(1)
        # pending-timeout queue entries by callback id: cancelled the moment
        # the (final) reply or failure resolves the callback — a completed
        # request must not leave a dead lambda in the heap for the full
        # timeout horizon (measurable heap bloat in long burns)
        self._timeout_entries: Dict[int, List] = {}

    def send(self, to: int, request) -> None:
        if self.dead:
            return
        self.cluster.route_request(self.node_id, to, request, callback_id=0)

    def send_with_callback(self, to: int, request, callback: api.Callback) -> None:
        if self.dead:
            return
        cid = next(self._callback_seq)
        self._callbacks[cid] = callback
        self.cluster.route_request(self.node_id, to, request, callback_id=cid)
        timeout = self.cluster.request_timeout_micros
        # barrier reads (sync points, commit-fused reads, WaitOnCommit) reply
        # only when the replica's drain releases them — give them room before
        # declaring the replica dead (ref: Maelstrom sink's per-type sweeper)
        if getattr(request, "is_slow_read", False):
            timeout *= 10
        # small deterministic jitter: co-scheduled requests (a coordinator
        # fanning one message to every replica in one quantum) must not
        # time out at the same instant and fire as a synchronized retry
        # storm.  Drawn from a dedicated stream so the protocol/chaos
        # randomness is untouched.
        timeout += self.cluster.timeout_jitter()
        self._timeout_entries[cid] = self.cluster.queue.add(
            self.cluster.queue.now + timeout,
            lambda: self._fail_pending(cid, to, f"timeout to {to}"))

    def reply(self, to: int, reply_context, reply) -> None:
        if self.dead or reply_context is None:
            return   # local requests (Propagate) have no reply path
        self.cluster.route_reply(self.node_id, to, reply_context, reply)

    def fail_callback(self, cid: int, from_id: int) -> None:
        """The network told us the request failed (Action.FAILURE /
        DELIVER_WITH_FAILURE) — fail the pending callback now; a late real
        reply for the same cid is ignored (already popped), exactly like a
        reply racing a timeout."""
        self._fail_pending(cid, from_id, f"reported-failed to {from_id}")

    def _fail_pending(self, cid: int, from_id: int, msg: str) -> None:
        if self.dead:
            return
        entry = self._timeout_entries.pop(cid, None)
        if entry is not None:
            PendingQueue.cancel(entry)
        cb = self._callbacks.pop(cid, None)
        if cb is not None:
            from ..coordinate.errors import Timeout as TimeoutError_
            self.cluster.schedule_at_node(
                self.node_id,
                lambda: cb.on_failure(from_id, TimeoutError_(msg=msg)))

    # -- inbound (called by cluster on delivery) ----------------------------
    def deliver_reply(self, from_id: int, reply_context: _ReplyContext, reply) -> None:
        cid = reply_context.callback_id
        cb = self._callbacks.get(cid)
        if cb is None:
            return
        final = reply.is_final() if hasattr(reply, "is_final") else True
        if final:
            del self._callbacks[cid]
            entry = self._timeout_entries.pop(cid, None)
            if entry is not None:
                PendingQueue.cancel(entry)
        from ..messages.base import FailureReply
        if isinstance(reply, FailureReply):
            cb.on_failure(from_id, reply.failure)
        else:
            cb.on_success(from_id, reply)

class SimConfigService(api.ConfigurationService):
    """Static/epoch-list configuration service
    (ref: maelstrom/SimpleConfigService.java + test MockConfigurationService)."""

    def __init__(self, cluster: "Cluster", node_id: int):
        self.cluster = cluster
        self.node_id = node_id
        self.listeners: List = []

    def register_listener(self, listener) -> None:
        self.listeners.append(listener)

    def current_topology(self) -> Topology:
        return self.cluster.topologies[-1]

    def get_topology_for_epoch(self, epoch: int) -> Optional[Topology]:
        for t in self.cluster.topologies:
            if t.epoch == epoch:
                return t
        return None

    def fetch_topology_for_epoch(self, epoch: int) -> None:
        t = self.get_topology_for_epoch(epoch)
        if t is not None:
            node = self.cluster.nodes[self.node_id]
            self.cluster.schedule_at_node(
                self.node_id, lambda: node.on_topology_update(t))

    def acknowledge_epoch(self, epoch_ready, start_sync: bool = True) -> None:
        # gossip "sync complete" to everyone (ref: onRemoteSyncComplete)
        epoch = epoch_ready.epoch
        for other in self.cluster.nodes.values():
            self.cluster.schedule_at_node(
                other.node_id,
                lambda o=other: o.topology_manager.on_epoch_sync_complete(
                    self.node_id, epoch))


class SimAgent(api.Agent):
    """(ref: test impl TestAgent)."""

    def __init__(self, cluster: "Cluster"):
        self.cluster = cluster

    def on_uncaught_exception(self, failure: BaseException) -> None:
        self.cluster.failures.append(failure)

    def on_handled_exception(self, failure: BaseException) -> None:
        pass

    def on_inconsistent_timestamp(self, command, prev, next_ts) -> None:
        self.cluster.failures.append(
            AssertionError(f"inconsistent timestamp {prev} vs {next_ts} on {command}"))


class Cluster:
    """(ref: impl/basic/Cluster.java)."""

    def __init__(self, node_ids: Optional[Sequence[int]] = None,
                 topology: Topology = None,
                 seed: int = 0, num_stores: int = 2,
                 data_store_factory: Optional[Callable[[int], api.DataStore]] = None,
                 progress_log_factory=None,
                 mean_latency_micros: int = 1_000,
                 request_timeout_micros: int = 1_000_000,
                 device_mode: Optional[bool] = None,
                 paged_limit: Optional[int] = None,
                 journal_factory: Optional[Callable[[int], object]] = None,
                 device="cuda", mesh="auto"):
        node_ids = list(node_ids if node_ids is not None else topology.nodes())
        self._device_mode = device_mode
        # torch device of every node's device plane ("cuda" unless asked)
        self._device = device
        self._mesh = mesh
        self._paged_limit = paged_limit
        # per-node journal constructor override (default: the in-memory
        # Journal; tests pass accord_tpu.journal.DurableJournal to run the
        # whole sim over the on-disk WAL stack)
        self._journal_factory = journal_factory
        self.random = RandomSource(seed)
        # dedicated stream for request-timeout jitter: seeded from the run
        # seed WITHOUT consuming a draw from ``self.random`` (node/restart
        # fork seeds stay exactly what they were without jitter)
        self._timeout_rng = RandomSource(seed ^ 0x7E9_1713)
        self.queue = PendingQueue()
        self.topologies: List[Topology] = [topology] if topology else []
        self.nodes: Dict[int, Node] = {}
        self.sinks: Dict[int, NodeSink] = {}
        self.failures: List[BaseException] = []
        self.mean_latency_micros = mean_latency_micros
        self.request_timeout_micros = request_timeout_micros
        self._data_store_factory = data_store_factory
        self._progress_log_factory = progress_log_factory
        self._num_stores = num_stores
        self.partitioned: Set[frozenset] = set()  # pairs that cannot talk
        self.drop_probability = 0.0
        self.deliver_with_failure_probability = 0.0
        self.failure_probability = 0.0
        # per-node clock drift: node_id -> (num, den, offset_micros); a
        # node's local clock reads queue.now * num // den + offset
        # (ref: BurnTest.java:330-340 FrequentLargeRange clock drift).
        # Rational arithmetic keeps the simulation bit-deterministic.
        self.clock_drift: Dict[int, Tuple[int, int, int]] = {}
        # per-directed-link FIFO floor: messages on one link never reorder
        # (TCP-like; multi-part replies such as CommitOk-then-ReadOk rely on
        # it).  Latency stays random ACROSS links.
        self._link_last: Dict[tuple, int] = {}
        # test hook (ref: test NetworkFilter): return True to drop a request
        self.message_filter: Optional[Callable[[int, int, object], bool]] = None
        # recovery-nemesis hook (r14): the most recent BeginRecovery
        # observed on the wire — (coordinator id, txn_id, route).  Purely
        # observational (set from the deterministic routing path), consumed
        # by the burn's recovery-under-chaos nemesis to aim its legs
        # (coordinator kill / partition / ballot race) at a LIVE recovery.
        self.last_recovery: Optional[Tuple[int, object, object]] = None
        # unified observability (obs.Observability): the metrics registry
        # is ALWAYS live — it is the store behind ``stats`` — while span
        # recording obeys the ACCORD_TPU_OBS knob.  ``stats`` keeps its
        # exact legacy keys (LegacyStats is a dict-compatible view over
        # registry counters), so every determinism gate compares the same
        # bytes it always did.
        from ..obs import Observability
        from ..obs.metrics import LegacyStats
        self.obs = Observability(now=lambda: self.queue.now)
        self.stats = LegacyStats(self.obs.metrics)
        if self.obs.flight is not None:
            # post-mortem bundles capture the live per-store device gauges
            # at the anomaly; read through self.nodes so restarts and
            # topology growth stay covered (sorted for byte-determinism)
            from ..obs.metrics import index_counters

            def device_gauges():
                out = {}
                for nid in sorted(self.nodes):
                    stores = self.nodes[nid].command_stores
                    for s in stores.unsafe_all_stores():
                        if s.device is not None:
                            out[f"{nid}/{s.store_id}"] = \
                                index_counters(s.device)
                return out

            self.obs.flight.gauge_source = device_gauges
        # structured event trace (ref: accord.impl.basic.Trace); off unless
        # a Trace instance is attached
        self.trace = None
        # per-node durability scheduling, driven by explicit ticks (sim) —
        # (ref: CoordinateDurabilityScheduling wired in test Cluster.java)
        self.durability: Dict[int, "object"] = {}
        # per-node-identity durable journal: survives restart_node
        # (ref: the simulation Journal, impl/basic/Journal.java)
        from ..local.journal import Journal
        self.journals: Dict[int, Journal] = {}

        scheduler = SimScheduler(self.queue)
        for nid in node_ids:
            sink = NodeSink(nid, self)
            self.sinks[nid] = sink
            data_store = (data_store_factory(nid) if data_store_factory
                          else _NullDataStore())
            self.journals[nid] = (journal_factory(nid) if journal_factory
                                  else Journal())
            node = Node(
                node_id=nid, message_sink=sink,
                config_service=SimConfigService(self, nid),
                scheduler=scheduler, data_store=data_store,
                agent=SimAgent(self), random=self.random.fork(),
                now_micros=lambda nid=nid: self.node_now(nid),
                progress_log_factory=progress_log_factory,
                num_stores=num_stores, device_mode=device_mode,
                journal=self.journals[nid], paged_limit=paged_limit,
                device=device, mesh=mesh)
            self.nodes[nid] = node
            from ..impl.durability_scheduling import DurabilityScheduling
            self.durability[nid] = DurabilityScheduling(node)
            self._wire_route_trace(node)
        if topology is not None:
            for node in self.nodes.values():
                node.on_topology_update(topology)

    def _wire_route_trace(self, node: "Node") -> None:
        """Surface every DeviceState deps-scan routing decision through the
        cluster stats (always) and the structured trace (when attached) —
        the sim-side leg of the route observability the bench's ``# index``
        line provides (utils.trace.Trace.record_route).  A node-level
        observer, so stores created later (topology updates, bootstrap)
        are covered without re-wiring."""
        node.obs = self.obs    # span recorder for the coordinate FSMs

        def observer(store, route, nq, tids=None, nid=node.node_id):
            key = "DepsRoute." + route
            self.stats[key] = self.stats.get(key, 0) + nq
            self.obs.metrics.counter("deps_route_queries",
                                     node=nid, route=route).inc(nq)
            sid = getattr(store, "store_id", -1)
            if self.obs.flight is not None:
                self.obs.flight.on_route(nid, sid, route, nq)
            if self.trace is not None:
                self.trace.record_route(self.queue.now, nid, sid, route, nq)
            sp = self.obs.spans
            if sp is not None and tids:
                # stamp the route each txn's deps scan actually took onto
                # its span tree (the ISSUE's "deps route taken"); unknown
                # txn keys (non-coordinated scans) drop inside event()
                for tid in tids:
                    sp.event(str(tid), "deps_route", route=route,
                             node=nid, store=sid)

        node.route_observer = observer

        def fault_observer(store, event, detail, nid=node.node_id):
            """Device-fault/degradation events from DeviceState: counted in
            stats (always) and the structured trace (when attached) — the
            sim-side leg of the degradation-ladder observability."""
            key = "DeviceFault." + event
            self.stats[key] = self.stats.get(key, 0) + 1
            self.obs.metrics.counter("device_fault_events",
                                     node=nid, event=event).inc()
            if self.obs.flight is not None:
                self.obs.flight.on_fault(nid, getattr(store, "store_id", -1),
                                         event, detail)
            if self.trace is not None:
                sid = getattr(store, "store_id", -1)
                if event in ("quarantine", "reprobe", "restore"):
                    self.trace.record_quarantine(self.queue.now, nid, sid,
                                                 event, detail)
                else:
                    self.trace.record_fault(self.queue.now, nid, sid,
                                            event, detail)

        node.fault_observer = fault_observer

        def drain_observer(store, mode, frontier, nid=node.node_id):
            """One drain-tick frontier sweep (mode device/fused/host/ell/
            mesh, frontier = ready candidates): the drain-regime forensics
            leg — per-tick frontier sizes as a registry histogram and a
            flight-ring entry, so a drain stall's shape (many empty sweeps?
            one giant antichain?) is in the post-mortem, not lost."""
            m = self.obs.metrics
            m.counter("drain_ticks", node=nid, mode=mode).inc()
            m.histogram("drain_frontier_size", node=nid).observe(frontier)
            if self.obs.flight is not None:
                self.obs.flight.on_drain(nid, getattr(store, "store_id", -1),
                                         mode, frontier)

        node.drain_observer = drain_observer

        disp = getattr(node, "dispatcher", None)
        if disp is not None:
            def fused_observer(kind, members, nq, nid=node.node_id):
                """One fused cross-store launch (flush or tick) from the
                node's DeviceDispatcher: counted in stats (always) and the
                structured trace (when attached) — the harvest-barrier leg
                of the r08 launch-coalescing observability."""
                key = "DeviceDispatch.fused_" + kind
                self.stats[key] = self.stats.get(key, 0) + 1
                m = self.obs.metrics
                m.counter("fused_launches", node=nid, kind=kind).inc()
                m.counter("fused_members", node=nid, kind=kind).inc(members)
                if self.obs.flight is not None:
                    self.obs.flight.on_fused(nid, kind, members, nq)
                if self.trace is not None:
                    self.trace.record_fused(self.queue.now, nid, kind,
                                            members, nq)

            disp.on_fused = fused_observer

    def timeout_jitter(self) -> int:
        """Small deterministic per-request timeout jitter (micros)."""
        return self._timeout_rng.next_int(4096)

    def node_now(self, nid: int) -> int:
        """The node's drifted local clock (simulated time by default)."""
        d = self.clock_drift.get(nid)
        if d is None:
            return self.queue.now
        num, den, offset = d
        return self.queue.now * num // den + offset

    # -- network ------------------------------------------------------------
    def _latency(self) -> int:
        # uniform in [mean/2, 3*mean/2] (ref: RandomDelayQueue LatencySupplier)
        m = self.mean_latency_micros
        return m // 2 + self.random.next_int(m + 1)

    def _action(self, src: int, dst: int) -> Action:
        if src != dst:
            if frozenset((src, dst)) in self.partitioned:
                return Action.DROP
            if self.drop_probability and self.random.decide(self.drop_probability):
                return Action.DROP
            # delivered-but-reported-failed: the classic duplicate-
            # coordination trigger — the sender believes the request died
            # and retries/recovers while it actually took effect
            # (ref: NodeSink.java:46 DELIVER_WITH_FAILURE)
            if self.deliver_with_failure_probability and self.random.decide(
                    self.deliver_with_failure_probability):
                return Action.DELIVER_WITH_FAILURE
            # fast-failure: not delivered AND the sender is told so
            # immediately, instead of waiting out the timeout (ref: FAILURE)
            if self.failure_probability and self.random.decide(
                    self.failure_probability):
                return Action.FAILURE
        return Action.DELIVER

    def _deliver_at(self, src: int, dst: int) -> int:
        at = self.queue.now + (self._latency() if src != dst else 0)
        key = (src, dst)
        at = max(at, self._link_last.get(key, 0))
        self._link_last[key] = at
        return at

    def route_request(self, src: int, dst: int, request, callback_id: int) -> None:
        verb = type(request).__name__
        self.stats[verb] = self.stats.get(verb, 0) + 1
        if verb == "BeginRecovery":
            self.last_recovery = (src, request.txn_id, request.route)
        action = self._action(src, dst)
        filtered = (action in (Action.DROP, Action.FAILURE)
                    or (self.message_filter is not None
                        and self.message_filter(src, dst, request)))
        if self.trace is not None:
            self.trace.record(self.queue.now,
                              "SEND" if not filtered else "DROP",
                              src, dst, repr(request))
        if action in (Action.DELIVER_WITH_FAILURE, Action.FAILURE) \
                and callback_id:
            # FAILURE is the fast-failure report (told so promptly, ref
            # Cluster's Action.FAILURE): fire the callback after a tiny
            # constant delay — far below link latency, so it exercises the
            # fast-failure timing race a 1-RTT loss cannot, while staying
            # asynchronous (an instant callback would re-enter the
            # coordinator from inside its own send loop).
            # DELIVER_WITH_FAILURE keeps the delivery-latency failure (the
            # "delivered but reported failed" race).  The latency draw is
            # taken either way so the FAILURE leg perturbs neither the
            # random stream nor the link's in-order watermark.
            linked_at = self._deliver_at(src, dst)
            fail_at = self.queue.now + 10 if action is Action.FAILURE \
                else linked_at
            self.queue.add(fail_at, lambda: (
                self.sinks[src].fail_callback(callback_id, dst)))
        if filtered:
            return
        ctx = _ReplyContext(src, callback_id)
        self.queue.add(self._deliver_at(src, dst),
                       lambda: self.nodes[dst].receive(request, src, ctx))

    def route_reply(self, src: int, dst: int, ctx: _ReplyContext, reply) -> None:
        self.stats[type(reply).__name__] = self.stats.get(type(reply).__name__, 0) + 1
        action = self._action(src, dst)
        # a reply has no callback of its own: FAILURE degrades to a plain
        # loss; DELIVER_WITH_FAILURE degrades to a plain delivery
        if self.trace is not None:
            delivered = action in (Action.DELIVER,
                                   Action.DELIVER_WITH_FAILURE)
            self.trace.record(self.queue.now,
                              "REPLY" if delivered else "DROP_REPLY",
                              src, dst, repr(reply))
        if action in (Action.DROP, Action.FAILURE):
            return
        self.queue.add(self._deliver_at(src, dst),
                       lambda: self.sinks[dst].deliver_reply(src, ctx, reply))

    def schedule_at_node(self, node_id: int, fn: Callable[[], None]) -> None:
        self.queue.add(self.queue.now, fn)

    # -- reconfiguration ----------------------------------------------------
    def add_topology(self, topology: Topology) -> None:
        """Introduce a new epoch: every node learns it (simulated delivery),
        updates its stores, bootstraps added ranges, syncs, and acks
        (ref: Cluster topology updates + TopologyRandomizer delivery)."""
        assert topology.epoch == self.topologies[-1].epoch + 1
        self.topologies.append(topology)
        for nid in topology.nodes() | set(self.nodes):
            node = self.nodes.get(nid)
            if node is None:
                # a genuinely new node joins the cluster
                node = self._add_node(nid)
            self.queue.add(self.queue.now + self._latency(),
                           lambda n=node: n.on_topology_update(topology))

    def _add_node(self, nid: int) -> Node:
        from ..local.journal import Journal
        scheduler = SimScheduler(self.queue)
        sink = NodeSink(nid, self)
        self.sinks[nid] = sink
        data_store = (self._data_store_factory(nid) if self._data_store_factory
                      else _NullDataStore())
        if nid not in self.journals:
            self.journals[nid] = (self._journal_factory(nid)
                                  if self._journal_factory else Journal())
        node = Node(node_id=nid, message_sink=sink,
                    config_service=SimConfigService(self, nid),
                    scheduler=scheduler, data_store=data_store,
                    agent=SimAgent(self), random=self.random.fork(),
                    now_micros=lambda nid=nid: self.node_now(nid),
                    progress_log_factory=self._progress_log_factory,
                    num_stores=self._num_stores,
                    device_mode=self._device_mode,
                    journal=self.journals[nid],
                    paged_limit=self._paged_limit,
                    device=self._device, mesh=self._mesh)
        self.nodes[nid] = node
        from ..impl.durability_scheduling import DurabilityScheduling
        self.durability[nid] = DurabilityScheduling(node)
        self._wire_route_trace(node)
        # the joiner must know prior epochs to pick bootstrap donors
        for t in self.topologies:
            self.queue.add(self.queue.now,
                           lambda tt=t, n=node: n.on_topology_update(tt))
        return node

    # -- restart ------------------------------------------------------------
    def restart_node(self, nid: int) -> Node:
        """Crash-and-restart one node: the old incarnation's process state
        (in-flight coordinations, listeners, caches) dies; the durable state
        (data store + journal) survives, and the new incarnation rebuilds
        its command stores from the journal
        (ref: the journal-reload leg of the burn test,
        impl/basic/DelayedCommandStores.java:96-175 — generalized to a full
        process restart)."""
        old = self.nodes[nid]
        old.alive = False
        old_sink = self.sinks[nid]
        old_sink.dead = True
        if self.trace is not None:
            self.trace.record(self.queue.now, "RESTART", nid, nid, "")
        sink = NodeSink(nid, self)
        # continue the callback numbering: a late reply addressed to a dead
        # incarnation's callback id must never resolve to a fresh callback
        # of the new incarnation (type confusion — e.g. a ghost ReadOk
        # delivered into a Propose round)
        sink._callback_seq = old_sink._callback_seq
        self.sinks[nid] = sink
        node = Node(node_id=nid, message_sink=sink,
                    config_service=SimConfigService(self, nid),
                    scheduler=SimScheduler(self.queue),
                    data_store=old.data_store,        # durable
                    agent=SimAgent(self), random=self.random.fork(),
                    now_micros=lambda nid=nid: self.node_now(nid),
                    progress_log_factory=self._progress_log_factory,
                    num_stores=self._num_stores,
                    device_mode=self._device_mode,
                    journal=self.journals[nid],
                    paged_limit=self._paged_limit,       # durable
                    device=self._device, mesh=self._mesh)
        self.nodes[nid] = node
        from ..impl.durability_scheduling import DurabilityScheduling
        self.durability[nid] = DurabilityScheduling(node)
        self._wire_route_trace(node)
        node.restore_topologies(self.topologies)
        self.journals[nid].restore(node)
        return node

    # -- partitions / chaos -------------------------------------------------
    def partition(self, a: int, b: int) -> None:
        self.partitioned.add(frozenset((a, b)))

    def heal(self) -> None:
        self.partitioned.clear()

    # -- run loop -----------------------------------------------------------
    def run_until_quiescent(self, max_micros: int = 60_000_000) -> None:
        """Run until the queue is empty or the deadline passes.  The
        deadline is checked against the NEXT event's time (like run_for):
        popping first would advance ``now`` past the deadline and still
        run the event — work scheduled beyond the horizon must not
        execute."""
        deadline = self.queue.now + max_micros
        while True:
            t = self._peek_time()
            if t is None or t > deadline:
                return
            fn = self.queue.pop()
            if fn is None:
                return
            fn()

    def run_for(self, micros: int) -> None:
        deadline = self.queue.now + micros
        while self._peek_time() is not None and self._peek_time() <= deadline:
            fn = self.queue.pop()
            if fn is None:
                break
            fn()
        self.queue.now = max(self.queue.now, deadline)

    def _peek_time(self) -> Optional[int]:
        while self.queue._heap and self.queue._heap[0][2] is None:
            heapq.heappop(self.queue._heap)
        return self.queue._heap[0][0] if self.queue._heap else None


class _NullDataStore(api.DataStore):
    pass
