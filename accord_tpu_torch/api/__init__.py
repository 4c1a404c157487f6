"""The SPI (ports) an integration implements.

TPU-native rebuild of the reference's accord.api package
(ref: accord-core/src/main/java/accord/api/ — Agent.java:33-70,
DataStore.java:39-111, MessageSink.java:28, ConfigurationService.java:59,
ProgressLog.java:59-213, Scheduler.java:26, TopologySorter.java,
Read.java/Update.java/Query.java, EventsListener.java:26-60,
config/LocalConfig.java:23-29).

These are the seams that the simulator, the maelstrom adapter, tests, and a
production integration plug into.  All are duck-typed ABCs; the data-plane
interfaces (Read/Write/Update/Query) return AsyncChains so store execution
can be batched onto the device without changing callers.
"""

from __future__ import annotations

import abc
from typing import Callable, List, Optional, Sequence

from ..primitives.keys import Ranges, Seekables
from ..primitives.timestamp import Timestamp, TxnId
from ..utils import async_chain


# ---------------------------------------------------------------------------
# Data plane (workload-defined)
# ---------------------------------------------------------------------------

class Data(abc.ABC):
    """Result of reads, mergeable across shards (ref: api/Data.java)."""

    @abc.abstractmethod
    def merge(self, other: "Data") -> "Data": ...


class Result:
    """Marker for the client-visible result (ref: api/Result.java)."""


class Read(abc.ABC):
    """(ref: api/Read.java) — read() returns an AsyncChain of Data."""

    @abc.abstractmethod
    def keys(self) -> Seekables: ...

    @abc.abstractmethod
    def read(self, key, safe_store, execute_at: Timestamp,
             store: "DataStore") -> "async_chain.AsyncChain[Data]": ...

    @abc.abstractmethod
    def slice(self, ranges: Ranges) -> "Read": ...

    @abc.abstractmethod
    def merge(self, other: Optional["Read"]) -> "Read": ...


class Write(abc.ABC):
    """(ref: api/Write.java)."""

    @abc.abstractmethod
    def apply(self, key, txn_id: TxnId, execute_at: Timestamp,
              store: "DataStore") -> "async_chain.AsyncChain": ...


class Update(abc.ABC):
    """(ref: api/Update.java)."""

    @abc.abstractmethod
    def keys(self) -> Seekables: ...

    @abc.abstractmethod
    def apply(self, execute_at: Timestamp, data: Optional[Data]) -> Write: ...

    @abc.abstractmethod
    def slice(self, ranges: Ranges) -> "Update": ...

    @abc.abstractmethod
    def merge(self, other: Optional["Update"]) -> "Update": ...


class Query(abc.ABC):
    """(ref: api/Query.java)."""

    @abc.abstractmethod
    def compute(self, txn_id: TxnId, execute_at: Timestamp, keys: Seekables,
                data: Optional[Data], read: Optional[Read],
                update: Optional[Update]) -> Result: ...


# ---------------------------------------------------------------------------
# DataStore + bootstrap fetch contract
# ---------------------------------------------------------------------------

class FetchRanges(abc.ABC):
    """Callbacks a fetch implementation reports into
    (ref: api/DataStore.java:49-86 StartingRangeFetch lifecycle)."""

    @abc.abstractmethod
    def starting(self, ranges: Ranges) -> "AbortFetch": ...

    @abc.abstractmethod
    def fetched(self, ranges: Ranges) -> None: ...

    @abc.abstractmethod
    def fail(self, ranges: Ranges, failure: BaseException) -> None: ...


class AbortFetch(abc.ABC):
    @abc.abstractmethod
    def abort(self) -> None: ...


class FetchResult(async_chain.AsyncResult):
    """Completes with the Ranges successfully fetched; cancellable
    (ref: api/DataStore.java:88-111)."""

    def abort(self) -> None:
        pass


class DataStore(abc.ABC):
    """Storage marker + snapshot fetch for bootstrap
    (ref: api/DataStore.java:39-111)."""

    def fetch(self, node, safe_store, ranges: Ranges, sync_point,
              fetch_ranges: FetchRanges) -> FetchResult:
        raise NotImplementedError

    def snapshot(self, ranges: Ranges) -> object:
        """Export the store's content for ``ranges`` (bootstrap donor side).
        The return value is opaque to the framework — it is shipped to the
        joining replica and handed to install_snapshot."""
        raise NotImplementedError

    def install_snapshot(self, snapshot: object) -> None:
        """Install a snapshot exported by a peer's snapshot() (bootstrap
        recipient side).  Must be idempotent and must keep any newer local
        writes (per-key last-writer-wins on executeAt)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Node-level callbacks
# ---------------------------------------------------------------------------

class Agent(abc.ABC):
    """Node-level integration callbacks (ref: api/Agent.java:33-70)."""

    def on_recover(self, node, success_result, fail) -> None:
        pass

    def on_inconsistent_timestamp(self, command, prev: Timestamp, next_ts: Timestamp) -> None:
        raise AssertionError(f"inconsistent timestamp: {prev} vs {next_ts}")

    def on_failed_bootstrap(self, phase: str, ranges: Ranges,
                            retry: Callable[[], None], failure: BaseException) -> None:
        retry()

    def on_stale(self, stale_since: Timestamp, ranges: Ranges) -> None:
        pass

    def on_uncaught_exception(self, failure: BaseException) -> None:
        raise failure

    def on_handled_exception(self, failure: BaseException) -> None:
        pass

    def is_expired(self, initiated_at: TxnId, now_micros: int) -> bool:
        """PreAccept timeout policy (ref: Agent.java preAcceptTimeout)."""
        return now_micros - initiated_at.hlc() > 1_000_000

    def expensive_to_coordinate(self, txn_id: TxnId) -> bool:
        return False

    def events_listener(self) -> "EventsListener":
        return NOOP_EVENTS


# ---------------------------------------------------------------------------
# Network out
# ---------------------------------------------------------------------------

class Callback(abc.ABC):
    """Reply handler for a request (ref: messages/Callback.java)."""

    @abc.abstractmethod
    def on_success(self, from_id: int, reply) -> None: ...

    @abc.abstractmethod
    def on_failure(self, from_id: int, failure: BaseException) -> None: ...

    def on_callback_failure(self, from_id: int, failure: BaseException) -> None:
        raise failure


class MessageSink(abc.ABC):
    """Network out (ref: api/MessageSink.java:28)."""

    @abc.abstractmethod
    def send(self, to: int, request) -> None: ...

    @abc.abstractmethod
    def send_with_callback(self, to: int, request, callback: Callback) -> None: ...

    @abc.abstractmethod
    def reply(self, to: int, reply_context, reply) -> None: ...

    def reply_with_unknown_failure(self, to: int, reply_context, failure: BaseException) -> None:
        from ..messages.base import FailureReply
        self.reply(to, reply_context, FailureReply(failure))


# ---------------------------------------------------------------------------
# Topology epoch source
# ---------------------------------------------------------------------------

class EpochReady:
    """Four-phase epoch readiness futures
    (ref: api/ConfigurationService.java EpochReady {metadata, coordination,
    data, reads})."""

    __slots__ = ("epoch", "metadata", "coordination", "data", "reads")

    def __init__(self, epoch: int,
                 metadata: async_chain.AsyncResult,
                 coordination: async_chain.AsyncResult,
                 data: async_chain.AsyncResult,
                 reads: async_chain.AsyncResult):
        self.epoch = epoch
        self.metadata = metadata
        self.coordination = coordination
        self.data = data
        self.reads = reads

    @classmethod
    def done(cls, epoch: int) -> "EpochReady":
        r = async_chain.AsyncResult()
        r.set_success(None)
        return cls(epoch, r, r, r, r)


class ConfigurationServiceListener(abc.ABC):
    def on_topology_update(self, topology, started_sync) -> async_chain.AsyncResult: ...
    def on_remote_sync_complete(self, node_id: int, epoch: int) -> None: ...
    def on_epoch_closed(self, ranges: Ranges, epoch: int) -> None: ...
    def on_epoch_redundant(self, ranges: Ranges, epoch: int) -> None: ...


class ConfigurationService(abc.ABC):
    """(ref: api/ConfigurationService.java:59)."""

    @abc.abstractmethod
    def register_listener(self, listener: ConfigurationServiceListener) -> None: ...

    @abc.abstractmethod
    def current_topology(self): ...

    @abc.abstractmethod
    def get_topology_for_epoch(self, epoch: int): ...

    @abc.abstractmethod
    def fetch_topology_for_epoch(self, epoch: int) -> None: ...

    @abc.abstractmethod
    def acknowledge_epoch(self, epoch_ready: EpochReady, start_sync: bool) -> None: ...

    def report_epoch_closed(self, ranges: Ranges, epoch: int) -> None:
        pass

    def report_epoch_redundant(self, ranges: Ranges, epoch: int) -> None:
        pass


# ---------------------------------------------------------------------------
# Liveness driver
# ---------------------------------------------------------------------------

class ProgressLog(abc.ABC):
    """Per-store liveness hooks, invoked on every status transition
    (ref: api/ProgressLog.java:59-213)."""

    def unwitnessed(self, safe_store, txn_id: TxnId) -> None: ...
    def pre_accepted(self, safe_store, txn_id: TxnId) -> None: ...
    def accepted(self, safe_store, txn_id: TxnId) -> None: ...
    def precommitted(self, safe_store, txn_id: TxnId) -> None: ...
    def stable(self, safe_store, txn_id: TxnId) -> None: ...
    def ready_to_execute(self, safe_store, txn_id: TxnId) -> None: ...
    def executed(self, safe_store, txn_id: TxnId) -> None: ...
    def durable(self, safe_store, txn_id: TxnId) -> None: ...
    def durable_local(self, safe_store, txn_id: TxnId) -> None: ...
    def waiting(self, blocked_by: TxnId, blocked_until: int, route, participants) -> None: ...
    def clear(self, txn_id: TxnId) -> None: ...


class NoOpProgressLog(ProgressLog):
    pass


# ---------------------------------------------------------------------------
# Timers
# ---------------------------------------------------------------------------

class Scheduled(abc.ABC):
    @abc.abstractmethod
    def cancel(self) -> None: ...

    def is_cancelled(self) -> bool:
        return False


class Scheduler(abc.ABC):
    """(ref: api/Scheduler.java:26)."""

    @abc.abstractmethod
    def once(self, delay_micros: int, run: Callable[[], None]) -> Scheduled: ...

    @abc.abstractmethod
    def recurring(self, interval_micros: int, run: Callable[[], None]) -> Scheduled: ...

    @abc.abstractmethod
    def now(self, run: Callable[[], None]) -> None: ...


# ---------------------------------------------------------------------------
# Replica contact ordering
# ---------------------------------------------------------------------------

class TopologySorter(abc.ABC):
    """(ref: api/TopologySorter.java) — compare two replicas for contact
    preference within some Topologies."""

    @abc.abstractmethod
    def compare(self, a: int, b: int, shards) -> int: ...


# ---------------------------------------------------------------------------
# Metrics events
# ---------------------------------------------------------------------------

class EventsListener:
    """(ref: api/EventsListener.java:26-60)."""

    def on_committed(self, txn_id: TxnId) -> None: ...
    def on_stable(self, command) -> None: ...
    def on_executed(self, command) -> None: ...
    def on_applied(self, command, start_nanos: int, end_nanos: int) -> None: ...
    def on_fast_path_taken(self, txn_id: TxnId, deps) -> None: ...
    def on_slow_path_taken(self, txn_id: TxnId, deps) -> None: ...
    def on_recover(self, txn_id: TxnId, outcome) -> None: ...
    def on_preempted(self, txn_id: TxnId) -> None: ...
    def on_timeout(self, txn_id: TxnId) -> None: ...
    def on_invalidated(self, txn_id: TxnId) -> None: ...


NOOP_EVENTS = EventsListener()


# ---------------------------------------------------------------------------
# Local config
# ---------------------------------------------------------------------------

class LocalConfig:
    """(ref: config/LocalConfig.java:23-29)."""

    def progress_log_schedule_delay_micros(self) -> int:
        return 200_000


class MutableLocalConfig(LocalConfig):
    def __init__(self, progress_delay_micros: int = 200_000):
        self._progress_delay = progress_delay_micros

    def progress_log_schedule_delay_micros(self) -> int:
        return self._progress_delay

    def set_progress_log_schedule_delay_micros(self, v: int) -> None:
        self._progress_delay = v
