"""Message-sourced durability: the per-node journal and restart/reload
reconstruction.

Rebuild of ref: accord-core/src/main/java/accord/local/SerializerSupport.java:96-420
and the simulation journal accord-core/src/test/java/accord/impl/basic/
Journal.java:82-171 + DelayedCommandStores.java:96-175.

The reference persists, per command, a handful of fixed-size *registers*
(SaveStatus, executeAt, promised/accepted ballots, durability) and
reconstructs every variable-size field (txn, deps, writes, result, route)
from the set of witnessed side-effecting *messages*
(``MessageType.hasSideEffects``, ``SerializerSupport.reconstruct``).  We keep
exactly that split:

- ``record_registers`` is hooked at the single command-update choke point
  (SafeCommandStore.update) — the registers are precisely the fixed-width
  columns of the command's struct-of-arrays form;
- ``record_message`` is hooked at Node._process for side-effecting verbs;
  local knowledge upgrades (coordinate/fetch_data.propagate) record the
  merged CheckStatusOk, mirroring the reference's PROPAGATE_* local messages;
- bootstrap watermarks/progress are tiny auxiliary records (the reference
  persists RedundantBefore et al as per-store fields via its integration's
  storage; only Commands are message-sourced).

Reconstruction comes in two grains:
- ``restore(node)``: full node restart — rebuild every store's commands,
  per-key conflict indexes, watermark maps and fences, then resume the
  execution drain;
- ``evict_and_reload(store, txn_id)``: the reference's cache-eviction test
  (random ``isLoadedCheck`` evictions) — drop one command and rebuild it
  from the journal in place, proving the serialization contract.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..primitives.keys import Ranges
from ..primitives.timestamp import Ballot, Timestamp, TxnId, TxnKind
from ..utils import invariants
from .command import Command, WaitingOn
from .status import Durability, SaveStatus, Status


# Message-body slots per txn, by what reconstruct() needs from them
# (ref: SerializerSupport PRE_ACCEPT_TYPES / ACCEPT / COMMIT / APPLY sets;
# txn bodies are captured generically from any message carrying one).
_COMMIT_TYPES = ("COMMIT_SLOW_PATH_REQ", "COMMIT_MAXIMAL_REQ",
                 "STABLE_FAST_PATH_REQ", "STABLE_SLOW_PATH_REQ",
                 "STABLE_MAXIMAL_REQ")
_APPLY_TYPES = ("APPLY_MINIMAL_REQ", "APPLY_MAXIMAL_REQ",
                "APPLY_THEN_WAIT_UNTIL_APPLIED_REQ")


class _Registers:
    """Fixed-width persisted columns of one command on one store
    (ref: the register args of SerializerSupport.reconstruct)."""

    __slots__ = ("save_status", "execute_at", "promised", "accepted",
                 "durability")

    def __init__(self, save_status: SaveStatus,
                 execute_at: Optional[Timestamp],
                 promised: Ballot, accepted: Ballot, durability: Durability):
        self.save_status = save_status
        self.execute_at = execute_at
        self.promised = promised
        self.accepted = accepted
        self.durability = durability


class _Bodies:
    """Witnessed side-effecting message bodies for one txn."""

    __slots__ = ("txn", "route", "accepts", "commit", "apply", "propagate")

    def __init__(self):
        self.txn = None          # latest full/partial txn seen in any message
        self.route = None
        self.accepts: List[Tuple[Ballot, object]] = []   # (ballot, request)
        self.commit = None       # best-hydration Commit request
        self.apply = None        # Apply request
        self.propagate = None    # merged CheckStatusOk from fetch_data


class Journal:
    """One node's durable log (survives Node object death)."""

    def __init__(self):
        self._bodies: Dict[TxnId, _Bodies] = {}
        self._registers: Dict[int, Dict[TxnId, _Registers]] = {}
        # per-store durable watermark snapshots, latest-wins (bounded —
        # replaying every SetShardDurable verb would grow with run length)
        self._watermarks: Dict[int, Tuple[list, list]] = {}
        # per-store bootstrap progress, NETTED: cumulative started ranges,
        # currently-done ranges, and the max fence watermark per range
        self._bs_started: Dict[int, Ranges] = {}
        self._bs_done: Dict[int, Ranges] = {}
        self._bs_marks: Dict[int, List[Tuple[Ranges, TxnId]]] = {}
        self.max_hlc = 0
        # flush-before-issue HLC reservation: a true upper bound on every
        # timestamp this node's past incarnations may have ISSUED (max_hlc
        # only bounds what got journaled somewhere — a coordinator whose
        # PreAccepts were all dropped could otherwise reissue a TxnId)
        self.hlc_reserved = 0
        self.restoring = False
        # diagnostics: reconstructions that had to degrade status for lack
        # of a message body (should stay 0 in healthy runs)
        self.degraded = 0
        # topology epoch ledger (r17, elastic serving): plain epoch docs
        # (net.reconfig.topology_to_doc shape), ascending, deduped by
        # epoch — a restarted node recovers the epoch history it had
        # ingested, including a proposal journaled but never broadcast
        self._topologies: List[dict] = []

    def record_topology(self, doc: dict) -> None:
        """One ingested/proposed topology epoch (latest contiguous ledger;
        a duplicate epoch is a no-op — ingest is idempotent)."""
        epoch = doc.get("epoch")
        if any(d.get("epoch") == epoch for d in self._topologies):
            return
        self._topologies.append(doc)
        self._topologies.sort(key=lambda d: d.get("epoch", 0))

    def topologies(self) -> List[dict]:
        return list(self._topologies)

    # -- recording -----------------------------------------------------------
    def record_message(self, request, from_id: int) -> None:
        if self.restoring:
            return
        txn_id = getattr(request, "txn_id", None)
        if txn_id is None:
            return
        type_name = request.type.name
        if type_name.startswith("PROPAGATE"):
            # local knowledge-upgrade message: its body is the merged
            # CheckStatusOk (ref: Propagate.java carries the found state)
            self.record_propagate(txn_id, request.ok)
            return
        self._note_hlc(txn_id)
        ex = getattr(request, "execute_at", None)
        if ex is not None:
            self._note_hlc(ex)
        b = self._bodies.get(txn_id)
        if b is None:
            b = self._bodies[txn_id] = _Bodies()
        route = getattr(request, "route", None)
        if route is not None:
            if b.route is None or (b.route.home_key is None
                                   and route.home_key is not None):
                b.route = route
            elif route.home_key is not None \
                    and route.home_key == b.route.home_key:
                b.route = b.route.with_(route)
            # else: divergent home key (a recovery coordinator picks its
            # own) — keep the existing route; either one is usable
        txn = getattr(request, "txn", None)
        if txn is not None:
            b.txn = txn
        if type_name == "ACCEPT_REQ":
            b.accepts.append((request.ballot, request))
        elif type_name in _COMMIT_TYPES:
            # prefer a body that carries the txn (maximal hydration)
            if b.commit is None or getattr(request, "txn", None) is not None:
                b.commit = request
        elif type_name in _APPLY_TYPES:
            if b.apply is None or getattr(request, "txn", None) is not None:
                b.apply = request

    def record_propagate(self, txn_id: TxnId, ok) -> None:
        """Local knowledge upgrade (ref: PROPAGATE_* local messages are
        side-effecting and journaled, messages/MessageType.java)."""
        if self.restoring:
            return
        b = self._bodies.get(txn_id)
        if b is None:
            b = self._bodies[txn_id] = _Bodies()
        b.propagate = ok if b.propagate is None else b.propagate.merge(ok)
        self._note_hlc(txn_id)
        if ok.execute_at is not None:
            self._note_hlc(ok.execute_at)

    def record_registers(self, store_id: int, command: Command) -> None:
        regs = self._registers.get(store_id)
        if regs is None:
            regs = self._registers[store_id] = {}
        if command.save_status is SaveStatus.Erased:
            # erased on this store: the watermarks answer for it here —
            # drop its registers (the journal's own truncation, ref: Cleanup
            # ERASE wipes the journal's messages)
            self.drop_register(store_id, command.txn_id)
            return
        regs[command.txn_id] = _Registers(
            command.save_status, command.execute_at, command.promised,
            command.accepted, command.durability)
        self._note_hlc(command.txn_id)
        if command.execute_at is not None:
            self._note_hlc(command.execute_at)

    def record_watermarks(self, store_id: int, durable_entries: list,
                          redundant_entries: list) -> None:
        """Latest durable/redundant watermark segments for one store
        (the reference persists RedundantBefore/DurableBefore as per-store
        fields; max-merge maps, so latest-wins is the whole history)."""
        self._watermarks[store_id] = (durable_entries, redundant_entries)

    def record_bootstrap(self, store_id: int, ranges: Ranges,
                         epoch: int) -> None:
        self._bs_started[store_id] = self._bs_started.get(
            store_id, Ranges.empty()).with_(ranges)
        # a re-bootstrap of previously-done ranges reopens them
        self._bs_done[store_id] = self._bs_done.get(
            store_id, Ranges.empty()).without(ranges)

    def record_bootstrapped_at(self, store_id: int, ranges: Ranges,
                               fence: TxnId) -> None:
        self._bs_marks.setdefault(store_id, []).append((ranges, fence))
        self._note_hlc(fence)

    def record_bootstrap_done(self, store_id: int, ranges: Ranges,
                              epoch: int) -> None:
        self._bs_done[store_id] = self._bs_done.get(
            store_id, Ranges.empty()).with_(ranges)

    def reserve_hlc(self, bound: int) -> None:
        """Batched id reservation: the node persists ``hlc + K`` before
        handing out ids up to that bound, so a restart restores a true
        upper bound on issued timestamps instead of a heuristic slack."""
        if bound > self.hlc_reserved:
            self.hlc_reserved = bound

    def _note_hlc(self, ts) -> None:
        h = ts.hlc()
        if h > self.max_hlc:
            self.max_hlc = h

    # -- reconstruction ------------------------------------------------------
    def registered_txns(self, store_id: int):
        return sorted(self._registers.get(store_id, {}))

    def has_register(self, store_id: int, txn_id: TxnId) -> bool:
        return txn_id in self._registers.get(store_id, {})

    def drop_register(self, store_id: int, txn_id: TxnId) -> None:
        """Erase one store's register (and the bodies once no store retains
        any) — the paged-out analogue of the Erased register drop."""
        regs = self._registers.get(store_id)
        if regs is not None:
            regs.pop(txn_id, None)
        if not any(txn_id in r for r in self._registers.values()):
            self._bodies.pop(txn_id, None)

    def reconstruct(self, store, txn_id: TxnId,
                    probe: bool = False) -> Optional[Command]:
        """Rebuild one command from registers + message bodies
        (ref: SerializerSupport.reconstruct).  WaitingOn is NOT built here —
        callers recompute it from the deps against current store state (the
        reference's waitingOnProvider), which also re-clears already-applied
        dependencies.  ``probe=True`` marks a fidelity check (page-out
        eligibility) rather than a real restore: a degraded probe keeps the
        command in memory and loses nothing, so it must not pollute the
        ``degraded`` diagnostic that healthy runs assert stays 0."""
        reg = self._registers.get(store.store_id, {}).get(txn_id)
        if reg is None:
            return None
        ss = reg.save_status
        # in-flight execution states resume one step back: transient waiters
        # died with the process, and re-running the write is idempotent
        # (the data store dedups by TxnId)
        if ss is SaveStatus.ReadyToExecute:
            ss = SaveStatus.Stable
        elif ss is SaveStatus.Applying:
            ss = SaveStatus.PreApplied
        b = self._bodies.get(txn_id) or _Bodies()
        route = b.route
        if route is None and b.propagate is not None:
            route = b.propagate.route

        if ss is SaveStatus.Invalidated:
            return Command(txn_id, save_status=SaveStatus.Invalidated,
                           durability=Durability.UniversalOrInvalidated,
                           route=route)
        if ss in (SaveStatus.Erased, SaveStatus.ErasedOrInvalidated):
            return Command(txn_id, save_status=ss, durability=reg.durability)
        if ss in (SaveStatus.TruncatedApply, SaveStatus.TruncatedApplyWithDeps,
                  SaveStatus.TruncatedApplyWithOutcome):
            writes, result = self._outcome(b)
            return Command(txn_id, save_status=ss, durability=reg.durability,
                           route=route, execute_at=reg.execute_at,
                           writes=writes, result=result)
        if ss in (SaveStatus.Uninitialised, SaveStatus.NotDefined):
            return Command(txn_id, save_status=ss, promised=reg.promised,
                           durability=reg.durability, route=route)

        owned = self._owned_window(store, txn_id, reg.execute_at)
        partial_txn = self._partial_txn(b, owned)
        partial_deps = None
        if ss >= SaveStatus.Committed:
            partial_deps = self._stable_deps(b, owned)
            if partial_deps is None:
                # commit body lost (should not happen): degrade to
                # PreCommitted and let the progress log re-fetch
                if not probe:
                    self.degraded += 1
                ss = SaveStatus.PreCommitted
        elif ss >= SaveStatus.Accepted and ss != SaveStatus.AcceptedInvalidate \
                and ss != SaveStatus.AcceptedInvalidateWithDefinition:
            partial_deps = self._accept_deps(b, reg.accepted, owned)
        if ss >= SaveStatus.PreAccepted and partial_txn is None \
                and ss.known.is_definition_known():
            if not probe:
                self.degraded += 1
            return Command(txn_id, save_status=SaveStatus.NotDefined,
                           promised=reg.promised, durability=reg.durability,
                           route=route)
        writes = result = None
        if ss >= SaveStatus.PreApplied:
            writes, result = self._outcome(b)
            if writes is None and result is None \
                    and not txn_id.kind().is_sync_point():
                if not probe:
                    self.degraded += 1
                ss = SaveStatus.Stable if partial_deps is not None \
                    else SaveStatus.PreCommitted
        waiting_on = WaitingOn.none() if ss is SaveStatus.Applied else None
        progress_key = None
        if route is not None and route.home_key is not None:
            progress_key = store.node.select_progress_key(txn_id, route)
        return Command(txn_id, save_status=ss, durability=reg.durability,
                       route=route, progress_key=progress_key,
                       promised=reg.promised, accepted=reg.accepted,
                       partial_txn=partial_txn, partial_deps=partial_deps,
                       execute_at=reg.execute_at, waiting_on=waiting_on,
                       writes=writes, result=result)

    def _owned_window(self, store, txn_id: TxnId,
                      execute_at: Optional[Timestamp]) -> Ranges:
        from .commands import apply_window_epochs
        min_epoch, max_epoch = apply_window_epochs(txn_id, execute_at)
        return store.ranges_for_epoch.all_between(min_epoch, max_epoch)

    @staticmethod
    def _partial_txn(b: _Bodies, owned: Ranges):
        src = None
        if b.txn is not None:
            src = b.txn
        elif b.commit is not None and getattr(b.commit, "txn", None) is not None:
            src = b.commit.txn
        elif b.apply is not None and getattr(b.apply, "txn", None) is not None:
            src = b.apply.txn
        elif b.propagate is not None and b.propagate.partial_txn is not None:
            src = b.propagate.partial_txn
        if src is None:
            return None
        return src.slice(owned, True)

    @staticmethod
    def _stable_deps(b: _Bodies, owned: Ranges):
        for src in (b.commit, b.apply):
            if src is not None and getattr(src, "deps", None) is not None:
                return src.deps.slice(owned)
        if b.propagate is not None and b.propagate.partial_deps is not None:
            return b.propagate.partial_deps.slice(owned)
        return None

    @staticmethod
    def _accept_deps(b: _Bodies, accepted: Ballot, owned: Ranges):
        chosen = None
        for ballot, req in b.accepts:
            if ballot == accepted:
                chosen = req
        if chosen is None and b.accepts:
            chosen = b.accepts[-1][1]
        if chosen is None or chosen.deps is None:
            return None
        return chosen.deps.slice(owned)

    @staticmethod
    def _outcome(b: _Bodies):
        if b.apply is not None:
            return b.apply.writes, b.apply.result
        if b.propagate is not None and b.propagate.writes is not None:
            return b.propagate.writes, b.propagate.result
        return None, None

    # -- full restart --------------------------------------------------------
    def restore(self, node) -> None:
        """Rebuild every store of a freshly-constructed node (topologies must
        already be fed via Node.restore_topologies).  Pass 1 installs
        watermarks + commands + per-key indexes synchronously; pass 2 (a
        store task per store) rebuilds WaitingOn frontiers and resumes the
        execution drain; finally interrupted bootstraps are restarted."""
        from .bootstrap import Bootstrap
        from .command_store import PreLoadContext
        stores = {s.store_id: s for s in node.command_stores.unsafe_all_stores()}
        self.restoring = True
        try:
            # watermarks first: dep-clearing in pass 2 needs them
            for sid, store in stores.items():
                for ranges, fence in self._bs_marks.get(sid, ()):
                    store.redundant_before.add_bootstrapped(ranges, fence)
                snap = self._watermarks.get(sid)
                if snap is not None:
                    durable, redundant = snap
                    store.durable_before.merge_entries(durable)
                    for start, end, before in redundant:
                        from ..primitives.keys import Range
                        store.redundant_before.add_redundant(
                            Ranges.of(Range(start, end)), before)
            for store in stores.values():
                for txn_id in self.registered_txns(store.store_id):
                    cmd = self.reconstruct(store, txn_id)
                    if cmd is None:
                        continue
                    store.commands[txn_id] = cmd
                    self._rebuild_indexes(store, cmd)
        finally:
            self.restoring = False
        for store in stores.values():
            store.execute(PreLoadContext.empty(), self._resume_drain)
        # re-bootstrap what lacks data coverage: interrupted fetches
        # (started - done) plus ranges adopted while this node was down
        # (owned now, but neither held since this node's first epoch nor
        # covered by any bootstrap record).  Rebased to the CURRENT epoch:
        # a fence coordinated now only reaches current owners, and the
        # multi-epoch donor sweep (Bootstrap._donors) finds the data.
        for sid, store in stores.items():
            owned = store.owned_current()
            if owned.is_empty():
                continue
            baseline = store.ranges_for_epoch.earliest()
            s = self._bs_started.get(sid, Ranges.empty())
            incomplete = s.without(self._bs_done.get(sid, Ranges.empty()))
            missed = owned.without(baseline).without(s)
            need = incomplete.with_(missed).intersecting(owned)
            if not need.is_empty():
                Bootstrap(store, need, max(2, node.epoch())).start()

    def _rebuild_indexes(self, store, cmd: Command) -> None:
        """Re-derive the non-journaled per-store indexes from a reconstructed
        command: CommandsForKey / range_commands, MaxConflicts, the
        ExclusiveSyncPoint fence, and the device mirror (all are caches over
        the command log — exactly why they are not persisted)."""
        from .commands_for_key import InternalStatus
        txn_id = cmd.txn_id
        if cmd.save_status in (SaveStatus.Erased,
                               SaveStatus.ErasedOrInvalidated):
            return
        if not txn_id.kind().is_globally_visible():
            return
        keys = cmd.partial_txn.keys if cmd.partial_txn is not None else None
        if keys is None:
            return
        status = _internal_status(cmd)
        execute_at = (cmd.execute_at if status.has_execute_at()
                      and cmd.execute_at is not None else None)
        if isinstance(keys, Ranges):
            if status is not InternalStatus.INVALIDATED:
                existing = store.range_commands.get(txn_id)
                store.put_range_command(txn_id, keys if existing is None
                                        else existing.with_(keys))
        else:
            from .commands import _per_key_deps
            for key in keys:
                store.cfk(key.token()).update(
                    txn_id, status, execute_at,
                    witnessed_deps=_per_key_deps(cmd.partial_deps,
                                                 key.token()))
        ts = cmd.execute_at if cmd.execute_at is not None else txn_id
        store.max_conflicts.update(keys, ts)
        if txn_id.kind() is TxnKind.ExclusiveSyncPoint \
                and isinstance(keys, Ranges) \
                and status is not InternalStatus.INVALIDATED:
            store.mark_reject_before(keys, txn_id)
        if store.device is not None:
            store.device.register(txn_id, int(status), keys)
            if execute_at is not None:
                store.device.update_status(txn_id, int(status), execute_at)

    def _resume_drain(self, safe) -> None:
        """Pass 2: rebuild WaitingOn for every Stable/PreApplied command (the
        reference's waitingOnProvider at reconstruct) and re-arm liveness."""
        from . import commands as commands_mod
        store = safe.store
        pending = [c for c in store.commands.values()
                   if c.save_status in (SaveStatus.Stable,
                                        SaveStatus.PreApplied)]
        pending.sort(key=lambda c: (c.execute_at or c.txn_id, c.txn_id))
        for cmd in pending:
            waiting_on = commands_mod.initialise_waiting_on(
                safe, cmd.txn_id, cmd.execute_at, cmd.partial_deps)
            cur = safe.get(cmd.txn_id)
            safe.update(cur.updated(waiting_on=waiting_on), notify=False)
            if not commands_mod.maybe_execute(safe, cmd.txn_id) \
                    and store.device is not None:
                store.device.arm(safe, cmd.txn_id)
        # re-seed the progress log so in-flight txns keep a liveness owner
        log = safe.progress_log()
        for cmd in store.commands.values():
            if cmd.is_truncated() or cmd.is_invalidated() \
                    or cmd.durability.is_durable():
                continue
            ss = cmd.save_status
            if ss is SaveStatus.Applied:
                log.durable_local(safe, cmd.txn_id)
            elif ss >= SaveStatus.Stable:
                log.stable(safe, cmd.txn_id)
            elif ss >= SaveStatus.Committed:
                log.precommitted(safe, cmd.txn_id)
            elif ss >= SaveStatus.Accepted:
                log.accepted(safe, cmd.txn_id)
            elif ss is SaveStatus.PreAccepted:
                log.pre_accepted(safe, cmd.txn_id)

    # -- cache eviction / reload --------------------------------------------
    def evict_and_reload(self, store, txn_id: TxnId):
        """Drop one command and rebuild it from the journal, in place
        (ref: DelayedCommandStores random isLoadedCheck evictions).  Runs as
        a store task; returns a chain of (evicted, reloaded) for tests.
        Durable listeners survive (the reference persists them in
        CommonAttributes); transient listeners live outside the command."""
        from . import commands as commands_mod
        from .command_store import PreLoadContext

        def task(safe):
            old = store.commands.get(txn_id)
            if old is None or old.save_status in (SaveStatus.Applying,):
                return None
            new = self.reconstruct(store, txn_id)
            if new is None:
                return None
            new = new.updated(listeners=old.listeners)
            if new.save_status in (SaveStatus.Stable, SaveStatus.PreApplied):
                waiting = commands_mod.initialise_waiting_on(
                    safe, txn_id, new.execute_at, new.partial_deps)
                new = new.updated(waiting_on=waiting)
            store.commands[txn_id] = new
            if new.save_status in (SaveStatus.Stable, SaveStatus.PreApplied):
                # mirror the stable()/apply() tail: still-waiting commands
                # must re-enter the drain — device mode has no listeners, so
                # an unarmed reloaded waiter would never wake (lost wakeup)
                if not commands_mod.maybe_execute(safe, txn_id) \
                        and store.device is not None:
                    store.device.arm(safe, txn_id)
            return (old, store.commands[txn_id])

        return store.execute(PreLoadContext.for_txn(txn_id), task)


def _internal_status(cmd: Command):
    from .commands_for_key import InternalStatus
    if cmd.is_invalidated():
        return InternalStatus.INVALIDATED
    if cmd.save_status is SaveStatus.Applied or cmd.is_truncated():
        return InternalStatus.APPLIED
    if cmd.has_been(Status.Stable):
        return InternalStatus.STABLE
    if cmd.has_been(Status.Committed):
        return InternalStatus.COMMITTED
    if cmd.has_been(Status.Accepted):
        return InternalStatus.ACCEPTED
    return InternalStatus.PREACCEPTED
