"""DurableJournal: the on-disk incarnation of the message-sourced journal.

``local/journal.py`` keeps the reference's split — fixed-width registers
per command plus the side-effecting message bodies everything else
reconstructs from — but lives in process memory, so a kill -9 forgets
every committed transaction.  :class:`DurableJournal` subclasses it and
makes every ``record_*`` fact ALSO a WAL record (wire-codec payloads —
the same serde the golden-frame loopback tests prove round-trips
byte-identically), so the in-memory semantics the sim's determinism
tiers pin are untouched while the facts become crash-durable:

====  =====================================================
kind  fact
====  =====================================================
msg   a side-effecting request witnessed (Node._process)
prop  a local knowledge upgrade (merged CheckStatusOk)
reg   one command's fixed-width registers on one store
wm    a store's durable/redundant watermark snapshot
bs*   bootstrap started / fenced-at / done
hlc   flush-before-issue HLC reservation (synchronous fsync)
reply a client txn reply owed/answered (at-most-once table)
apply one data-store append (token, values, executeAt, txn)
====  =====================================================

Group commit (`journal/commit.py`) batches the fsyncs; snapshots
(`journal/snapshot.py`) bound replay and recycle dead segments; recovery
(`journal/recover.py`) rebuilds this object from disk so ``Node`` takes
it through the exact ``journal=`` parameter and ``restore()`` path the
sim's restart tests already exercise.
"""

from __future__ import annotations

import os
import sys
from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import wire
from ..local.journal import Journal, _Bodies, _Registers
from ..local.status import SaveStatus
from ..primitives.timestamp import TxnId
from ..sim.kvstore import KVDataStore
from .commit import GroupCommit
from .wal import DEFAULT_SEGMENT_BYTES, WriteAheadLog

# client-reply dedupe horizon (same shape as net.client's SEEN_CAP): a
# duplicate request arrives within the client's retry horizon, so the
# most recent replies keep the at-most-once contract exact while a soak
# can't grow the table forever
REPLIED_CAP = 65536
# WAL records between snapshots.  The interval exists to bound the
# kill -9 rejoin wall (replay = records x replay rate) against the cost
# of a whole-state capture; r13 set 8192 against ~4.8k records/s of JSON
# replay, and the r16 binary record codec replays ~5x faster — same
# rejoin bound, 4x fewer whole-state walks (each is O(total state), the
# dominant journal tax once command state has grown)
DEFAULT_SNAPSHOT_EVERY = 32768


class DurableJournal(Journal):
    """On-disk journal.  Construction RECOVERS: any snapshot + WAL tail
    already in ``directory`` is loaded and replayed before the first new
    record lands (``replay_stats`` reports what came back)."""

    # what must be fsync-durable BEFORE which acknowledgement leaves:
    #
    # - "all":    every protocol reply gates on the batch fsync — the
    #   strict mode: a promise (PreAcceptOk witness, AcceptReply ballot)
    #   survives even a whole-box power loss.  Costs one group-commit
    #   cycle per protocol hop; on a slow-fsync filesystem that is the
    #   dominant serving cost.
    # - "client": only the client's ``txn_ok`` gates (default) — the
    #   user-visible durability promise holds ("acked => this txn's
    #   journal records are on disk at the answering node"), protocol
    #   replies ride on write()-to-page-cache.  A kill -9 (process
    #   death) loses NOTHING either way — the page cache survives the
    #   process — so crash recovery is identical; what "client" gives up
    #   is per-hop power-loss durability of un-acked protocol promises,
    #   where replication across nodes is the actual safety story
    #   (the same trade Cassandra's default periodic commitlog makes).
    # - "periodic": nothing gates; the batching window bounds the
    #   fsync lag.  Benchmarks and bulk loads.
    SYNC_POLICIES = ("all", "client", "periodic")

    def __init__(self, directory: str, *,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 snapshot_every: int = DEFAULT_SNAPSHOT_EVERY,
                 window_micros: Optional[int] = None,
                 defer=None, metrics=None, async_exec=None,
                 sync_policy: str = "client",
                 debug_capture: bool = False):
        super().__init__()
        if sync_policy not in self.SYNC_POLICIES:
            raise ValueError(f"sync_policy {sync_policy!r} not in "
                             f"{self.SYNC_POLICIES}")
        self.directory = directory
        self.metrics = metrics
        self.sync_policy = sync_policy
        self.snapshot_every = snapshot_every
        self._replaying = False
        self._snap_inflight = False
        self.replay_errors = 0
        # at-most-once client replies: (src, msg_id) -> reply body
        self.replied: Dict[Tuple[str, int], dict] = {}
        self._replied_order: deque = deque()
        # data-store appends recovered from disk, installed into the fresh
        # KVDataStore by install_data() before the node's restore() runs
        self._restored_data: Dict[int, List[tuple]] = {}
        self.debug_records: Optional[List[dict]] = [] if debug_capture \
            else None
        self.wal = WriteAheadLog(directory, segment_bytes=segment_bytes)
        self.commit = GroupCommit(self.wal, defer=defer,
                                  window_micros=window_micros,
                                  metrics=metrics, async_exec=async_exec)
        # r16: register rows are LATEST-WINS facts (replay installs the
        # last row per (store, txn)), so one group-commit window's worth
        # of transitions for one command serializes once, drained into
        # the batch by the commit's pre_flush hook.  Crash-equivalent:
        # everything appended since the last flush dies together anyway
        # (the r13 crash sweep already pins message-present/register-
        # stale truncation points as valid recovery states).
        self._pending_regs: Dict[tuple, object] = {}
        self.commit.pre_flush = self._drain_pending_registers
        self.commit.deferred_pending = lambda: bool(self._pending_regs)
        from . import recover as recover_mod
        self.replay_stats = recover_mod.replay(self)
        self._snap_floor = self.replay_stats["snapshot_floor"]

    # -- append plumbing -----------------------------------------------------
    def _append(self, doc: dict) -> None:
        if self._replaying:
            return
        try:
            seq = self.commit.append(doc)
        except Exception as exc:   # an unencodable payload must never
            self.replay_errors += 1   # take the node down
            print(f"[journal] append failed for kind "
                  f"{doc.get('k')!r}: {exc!r}", file=sys.stderr)
            return
        if seq is None:
            return   # degraded: the record never landed
        if self.metrics is not None:
            self.metrics.counter("journal_records", kind=doc["k"]).inc()
        if self.debug_records is not None:
            self.debug_records.append(dict(doc, s=seq))

    def has_restored_state(self) -> bool:
        return bool(self._registers or self._bodies or self._restored_data
                    or self.replied or self.hlc_reserved or self.max_hlc
                    or self._topologies)

    def gate_protocol_replies(self) -> bool:
        return self.sync_policy == "all"

    def gate_client_replies(self) -> bool:
        return self.sync_policy in ("all", "client")

    # -- recorded facts (each: WAL first, then the in-memory semantics) ------
    def record_message(self, request, from_id: int) -> None:
        if not self.restoring and not self._replaying:
            txn_id = getattr(request, "txn_id", None)
            if txn_id is not None \
                    and not request.type.name.startswith("PROPAGATE"):
                # PROPAGATE journals through record_propagate below (the
                # base class routes it there; journaling here too would
                # double-record the fact)
                try:
                    # r16: a request that arrived over the wire carries
                    # its own encoded doc (decode∘encode is the identity,
                    # pinned by the golden-frame gate) — re-encoding the
                    # whole payload tree per record was a first-order
                    # journal tax on the serving path
                    doc = getattr(request, "_wire_doc", None)
                    self._append({"k": "msg", "f": from_id,
                                  "p": doc if doc is not None
                                  else wire.encode(request)})
                except TypeError as exc:
                    # a side-effecting verb without a wire codec: loud
                    # once, never fatal (the in-memory journal still
                    # records it; only durability is lost for this verb)
                    self.replay_errors += 1
                    print(f"[journal] no codec for "
                          f"{type(request).__name__}: {exc}",
                          file=sys.stderr)
        super().record_message(request, from_id)

    def record_propagate(self, txn_id, ok) -> None:
        if not self.restoring and not self._replaying:
            self._append({"k": "prop", "t": wire.encode(txn_id),
                          "ok": wire.encode(ok)})
        super().record_propagate(txn_id, ok)

    def record_registers(self, store_id: int, command) -> None:
        if not self._replaying:
            if self.commit.failed:
                # degraded journal: no window ever drains again, so a
                # parked Command per (store, txn) would leak forever on
                # exactly the degraded-but-alive node the bounded-memory
                # contract covers
                self._pending_regs.clear()
            else:
                # park the command snapshot (immutable value object): the
                # window-close drain serializes only the LAST row per
                # (store, txn) — back-to-back transitions (commit+stable
                # in one message) cost one WAL record, not one each
                self._pending_regs[(store_id, command.txn_id)] = command
                self.commit.schedule_window()
        super().record_registers(store_id, command)

    def _drain_pending_registers(self) -> None:
        if not self._pending_regs:
            return
        pend, self._pending_regs = self._pending_regs, {}
        for (store_id, _txn_id), command in pend.items():
            # columnar v2 row: raw (msb, lsb, node) triples + enum NAMES
            # instead of six generic wire.encode walks — reg rows are
            # over half the WAL's records, and this was the serving
            # path's biggest per-record cost.  apply_record keeps the
            # r13 keyed shape decoding forever (journals outlive code).
            t = command.txn_id
            ex = command.execute_at
            pr = command.promised
            ac = command.accepted
            self._append({"k": "reg", "c": [
                store_id, [t.msb, t.lsb, t.node],
                command.save_status.name,
                # executeAt may literally BE the TxnId (the fast path);
                # a 4th element tags that so replay rebuilds the exact
                # type the live journal held (byte-identity contract)
                None if ex is None else
                ([ex.msb, ex.lsb, ex.node, 1] if isinstance(ex, TxnId)
                 else [ex.msb, ex.lsb, ex.node]),
                None if pr is None else [pr.msb, pr.lsb, pr.node],
                None if ac is None else [ac.msb, ac.lsb, ac.node],
                command.durability.name]})

    def record_watermarks(self, store_id: int, durable_entries: list,
                          redundant_entries: list) -> None:
        if not self._replaying:
            self._append({"k": "wm", "sid": store_id,
                          "d": wire.encode(list(durable_entries)),
                          "r": wire.encode(list(redundant_entries))})
        super().record_watermarks(store_id, durable_entries,
                                  redundant_entries)

    def record_bootstrap(self, store_id: int, ranges, epoch: int) -> None:
        if not self._replaying:
            self._append({"k": "bs", "sid": store_id,
                          "rg": wire.encode(ranges), "ep": epoch})
        super().record_bootstrap(store_id, ranges, epoch)

    def record_bootstrapped_at(self, store_id: int, ranges, fence) -> None:
        if not self._replaying:
            self._append({"k": "bsat", "sid": store_id,
                          "rg": wire.encode(ranges),
                          "f": wire.encode(fence)})
        super().record_bootstrapped_at(store_id, ranges, fence)

    def record_bootstrap_done(self, store_id: int, ranges,
                              epoch: int) -> None:
        if not self._replaying:
            self._append({"k": "bsd", "sid": store_id,
                          "rg": wire.encode(ranges), "ep": epoch})
        super().record_bootstrap_done(store_id, ranges, epoch)

    def record_topology(self, doc: dict) -> None:
        """One topology epoch ingested or proposed (r17, elastic serving):
        a WAL fact, so a node killed -9 mid-reconfiguration — proposer
        mid-propose included — recovers holding the exact epoch ledger it
        had.  The doc is already a plain JSON/msgpack payload
        (net.reconfig.topology_to_doc), so it rides the record codec
        as-is."""
        if not self._replaying \
                and not any(d.get("epoch") == doc.get("epoch")
                            for d in self._topologies):
            self._append({"k": "topo", "d": doc})
        super().record_topology(doc)

    def reserve_hlc(self, bound: int) -> None:
        if bound <= self.hlc_reserved:
            return
        if not self._replaying:
            self._append({"k": "hlc", "b": bound})
            # flush-before-issue: the reservation must be ON DISK before
            # any id up to the bound is handed out (one BLOCKING fsync
            # per ~million ids — the restart floor is exact, not a hope)
            self.commit.flush(sync=True)
        super().reserve_hlc(bound)

    # -- durable-only facts --------------------------------------------------
    def record_reply(self, src: str, msg_id: int, body: dict) -> None:
        """A client txn reply this node owes/answered: journaled so a
        restarted incarnation re-serves the SAME reply to a duplicate
        request instead of re-coordinating (at-most-once across death)."""
        if not self._replaying:
            self._append({"k": "reply", "src": src, "m": msg_id, "b": body})
        self._install_reply(src, msg_id, body)

    def replied_body(self, src: str, msg_id: int) -> Optional[dict]:
        return self.replied.get((src, msg_id))

    def _install_reply(self, src: str, msg_id: int, body: dict) -> None:
        key = (src, msg_id)
        if key not in self.replied:
            self._replied_order.append(key)
        self.replied[key] = body
        while len(self._replied_order) > REPLIED_CAP:
            self.replied.pop(self._replied_order.popleft(), None)

    def record_apply(self, token: int, values: tuple, execute_at,
                     txn_id) -> None:
        """One data-store append (the KV log is the node's only other
        durable state; journaling applies + snapshotting the log is what
        makes the 'data store is durable' restore premise true across a
        real process death)."""
        if not self._replaying:
            self._append({"k": "apply", "tok": token,
                          "v": wire.encode(tuple(values)),
                          "at": wire.encode(execute_at),
                          "t": wire.encode(txn_id)})

    def _install_apply(self, token: int, values: tuple, execute_at,
                       txn_id) -> None:
        entries = self._restored_data.setdefault(token, [])
        if any(tid == txn_id for _v, _at, tid in entries):
            return
        entries.append((tuple(values), execute_at, txn_id))

    def install_data(self, data_store: KVDataStore) -> None:
        """Seed a fresh data store with the recovered appends (sorted by
        executeAt, deduped by TxnId — same monotone-union contract as
        install_snapshot)."""
        for token, entries in self._restored_data.items():
            entries.sort(key=lambda e: e[1])
            data_store.log.setdefault(token, []).extend(entries)

    # -- replay (journal/recover.py drives this) -----------------------------
    def apply_record(self, doc: dict) -> None:
        k = doc["k"]
        if k == "msg":
            self.record_message(wire.decode(doc["p"]), doc["f"])
        elif k == "prop":
            self.record_propagate(wire.decode(doc["t"]),
                                  wire.decode(doc["ok"]))
        elif k == "reg":
            if "c" in doc:
                from ..local.status import Durability
                from ..primitives.timestamp import Ballot, Timestamp, TxnId
                sid, t, ss, ex, pr, ac, du = doc["c"]
                if ex is None:
                    ex_v = None
                elif len(ex) == 4:
                    ex_v = TxnId(ex[0], ex[1], ex[2])
                else:
                    ex_v = Timestamp(*ex)
                self._install_register(
                    sid, TxnId(*t), SaveStatus[ss], ex_v,
                    None if pr is None else Ballot(*pr),
                    None if ac is None else Ballot(*ac),
                    Durability[du])
            else:
                # r13/r16 keyed shape: journals on disk outlive code
                self._install_register(
                    doc["sid"], wire.decode(doc["t"]),
                    wire.decode(doc["ss"]), wire.decode(doc["ex"]),
                    wire.decode(doc["pr"]), wire.decode(doc["ac"]),
                    wire.decode(doc["du"]))
        elif k == "wm":
            super().record_watermarks(
                doc["sid"],
                [tuple(e) for e in wire.decode(doc["d"])],
                [tuple(e) for e in wire.decode(doc["r"])])
        elif k == "bs":
            super().record_bootstrap(doc["sid"], wire.decode(doc["rg"]),
                                     doc["ep"])
        elif k == "bsat":
            super().record_bootstrapped_at(doc["sid"],
                                           wire.decode(doc["rg"]),
                                           wire.decode(doc["f"]))
        elif k == "bsd":
            super().record_bootstrap_done(doc["sid"],
                                          wire.decode(doc["rg"]),
                                          doc["ep"])
        elif k == "topo":
            super().record_topology(doc["d"])
        elif k == "hlc":
            super().reserve_hlc(doc["b"])
        elif k == "reply":
            self._install_reply(doc["src"], doc["m"], doc["b"])
        elif k == "apply":
            self._install_apply(doc["tok"], tuple(wire.decode(doc["v"])),
                                wire.decode(doc["at"]),
                                wire.decode(doc["t"]))
        else:
            raise ValueError(f"unknown journal record kind {k!r}")

    def _install_register(self, store_id: int, txn_id, save_status,
                          execute_at, promised, accepted,
                          durability) -> None:
        """Replay-side mirror of Journal.record_registers (which needs a
        live Command; the WAL carries exactly its register columns)."""
        if save_status is SaveStatus.Erased:
            self.drop_register(store_id, txn_id)
            return
        regs = self._registers.setdefault(store_id, {})
        regs[txn_id] = _Registers(save_status, execute_at, promised,
                                  accepted, durability)
        self._note_hlc(txn_id)
        if execute_at is not None:
            self._note_hlc(execute_at)

    # -- whole-state serialization (the snapshot payload) --------------------
    def encode_state(self, data_store: Optional[KVDataStore] = None) -> dict:
        enc = wire.encode

        def enc_req(x):
            # a wire-arrived request carries its own encoded doc
            # (decode∘encode is the identity per the golden-frame gate —
            # the same premise record_message already banks on); the
            # whole-state walk re-encoding every body tree was the
            # snapshot's dominant cost
            d = getattr(x, "_wire_doc", None)
            return d if d is not None else enc(x)

        bodies = []
        for txn_id in sorted(self._bodies):
            b = self._bodies[txn_id]
            bodies.append([enc(txn_id), {
                "txn": enc(b.txn), "route": enc(b.route),
                "accepts": [[enc(bal), enc_req(req)]
                            for bal, req in b.accepts],
                "commit": enc_req(b.commit), "apply": enc_req(b.apply),
                "prop": enc(b.propagate)}])
        registers = []
        for sid in sorted(self._registers):
            regs = self._registers[sid]
            registers.append([sid, [
                [enc(t), [enc(r.save_status), enc(r.execute_at),
                          enc(r.promised), enc(r.accepted),
                          enc(r.durability)]]
                for t, r in sorted(regs.items())]])
        data: Dict[int, List[tuple]] = {}
        for token, entries in self._restored_data.items():
            data[token] = list(entries)
        if data_store is not None:
            for token, entries in data_store.log.items():
                have = {tid for _v, _at, tid in data.get(token, ())}
                data.setdefault(token, []).extend(
                    e for e in entries if e[2] not in have)
        for entries in data.values():
            entries.sort(key=lambda e: e[1])
        return {
            "bodies": bodies,
            "registers": registers,
            "watermarks": [[sid, enc(list(d)), enc(list(r))]
                           for sid, (d, r) in sorted(
                               self._watermarks.items())],
            "bs_started": [[sid, enc(r)] for sid, r in sorted(
                self._bs_started.items())],
            "bs_done": [[sid, enc(r)] for sid, r in sorted(
                self._bs_done.items())],
            "bs_marks": [[sid, [[enc(rg), enc(f)] for rg, f in marks]]
                         for sid, marks in sorted(self._bs_marks.items())],
            "max_hlc": self.max_hlc,
            "hlc_reserved": self.hlc_reserved,
            "replied": [[src, m, self.replied[(src, m)]]
                        for src, m in self._replied_order],
            # topology epoch ledger (r17): plain docs, snapshot-carried so
            # a recovery whose WAL floor passed the topo records still
            # restores the epoch history (absent in pre-r17 snapshots —
            # install_state tolerates the missing key forever)
            "topologies": list(self._topologies),
            "data": [[token, [[enc(v), enc(at), enc(t)]
                              for v, at, t in entries]]
                     for token, entries in sorted(data.items())],
        }

    def install_state(self, state: dict) -> None:
        dec = wire.decode
        for tdoc, bdoc in state["bodies"]:
            b = _Bodies()
            b.txn = dec(bdoc["txn"])
            b.route = dec(bdoc["route"])
            b.accepts = [(dec(bal), dec(req))
                         for bal, req in bdoc["accepts"]]
            b.commit = dec(bdoc["commit"])
            b.apply = dec(bdoc["apply"])
            b.propagate = dec(bdoc["prop"])
            self._bodies[dec(tdoc)] = b
        for sid, regs in state["registers"]:
            out = self._registers.setdefault(sid, {})
            for tdoc, cols in regs:
                out[dec(tdoc)] = _Registers(dec(cols[0]), dec(cols[1]),
                                            dec(cols[2]), dec(cols[3]),
                                            dec(cols[4]))
        for sid, d, r in state["watermarks"]:
            self._watermarks[sid] = ([tuple(e) for e in dec(d)],
                                     [tuple(e) for e in dec(r)])
        for sid, r in state["bs_started"]:
            self._bs_started[sid] = dec(r)
        for sid, r in state["bs_done"]:
            self._bs_done[sid] = dec(r)
        for sid, marks in state["bs_marks"]:
            self._bs_marks[sid] = [(dec(rg), dec(f)) for rg, f in marks]
        self.max_hlc = state["max_hlc"]
        self.hlc_reserved = state["hlc_reserved"]
        for src, m, body in state["replied"]:
            self._install_reply(src, m, body)
        for token, entries in state["data"]:
            self._restored_data[token] = [
                (tuple(dec(v)), dec(at), dec(t)) for v, at, t in entries]
        for doc in state.get("topologies", ()):   # absent pre-r17
            self.record_topology(doc)

    def canonical_state_json(self,
                             data_store: Optional[KVDataStore] = None) -> str:
        """Canonical bytes of the whole journal state — the crash-point
        sweep's byte-identity oracle."""
        import json
        return json.dumps(self.encode_state(data_store), sort_keys=True,
                          separators=(",", ":"))

    # -- snapshot + compaction ----------------------------------------------
    def maybe_snapshot(self, data_store: Optional[KVDataStore] = None,
                       force: bool = False, busy: bool = False) -> bool:
        """Write a snapshot when enough WAL has accumulated since the last
        floor; recycle every segment the new floor strands.

        Serving path (``async_exec`` wired, POSIX): the capture forks —
        the child encodes + writes + ``_exit``s against the fork-instant
        copy-on-write image (the BGSAVE shape), so the whole-state
        ``encode_state`` walk (measured: 300-600ms once the command state
        has grown) never stalls the protocol thread, and consistency is
        the fork's memory snapshot instead of a loop-thread capture.  The
        parent polls for the child and advances the floor on success.

        Fallback (no fork / fork failed): the state is captured on the
        calling (protocol) thread — consistency — and the file write +
        fsync ride the commit's worker when one is wired: an inline
        multi-ms snapshot fsync would stall every peer and client on the
        single event loop (the same stall class the async group commit
        exists to avoid)."""
        if self.commit.failed or self._replaying or self._snap_inflight:
            return False
        since = self.wal.tail_seq - self._snap_floor
        if not force and since < self.snapshot_every:
            return False
        if busy and not force and since < 4 * self.snapshot_every:
            # maintenance yields to traffic (the compaction-throttling
            # discipline): a loaded node defers the whole-state walk to
            # the next load valley — replay stays bounded by the 4x hard
            # cap, past which the snapshot runs regardless
            return False
        from .snapshot import write_snapshot
        floor = self.wal.tail_seq
        if (self.commit.async_exec is not None
                and self.commit.defer is not None and hasattr(os, "fork")):
            forked = self._snapshot_in_child(data_store, floor)
            if forked:
                return True
            # fork failed: fall through to the capture-on-thread paths
        state = self.encode_state(data_store)
        if self.commit.async_exec is not None:
            self._snap_inflight = True

            def work():
                write_snapshot(self.directory, floor, state,
                               metrics=self.metrics)

            def done(exc) -> None:
                self._snap_inflight = False
                if exc is not None:
                    print(f"[journal] snapshot failed: {exc!r}",
                          file=sys.stderr)
                    return
                self._snap_floor = floor
                self.wal.drop_below(floor)

            self.commit.async_exec(work, done)
            return True
        try:
            write_snapshot(self.directory, floor, state,
                           metrics=self.metrics)
        except OSError as exc:
            print(f"[journal] snapshot failed: {exc!r}", file=sys.stderr)
            return False
        self._snap_floor = floor
        self.wal.drop_below(floor)
        return True

    def _snapshot_in_child(self, data_store, floor: int) -> bool:
        """Fork; the child serializes the fork-instant state and writes
        the snapshot file, the parent polls and owns the floor advance.
        Returns False when the fork itself failed (caller falls back)."""
        from .snapshot import write_snapshot
        try:
            import warnings
            with warnings.catch_warnings():
                # jax warns on ANY os.fork in a process with its
                # threads; this child never touches jax (or any lock a
                # worker thread could hold at fork) — it runs pure-python
                # encode + raw file IO and os._exit()s
                warnings.simplefilter("ignore", RuntimeWarning)
                pid = os.fork()
        except OSError as exc:
            print(f"[journal] snapshot fork failed: {exc!r}",
                  file=sys.stderr)
            return False
        if pid == 0:
            # child: encode + write + _exit.  os._exit is REQUIRED — a
            # normal exit would flush the forked copy of the WAL's
            # buffered writer into the SHARED file offset (duplicate
            # bytes under the parent's tail).  No metrics (the parent
            # accounts on reap), no loop, no locks beyond a fresh GIL.
            code = 0
            try:
                write_snapshot(self.directory, floor,
                               self.encode_state(data_store), metrics=None)
            except BaseException:
                code = 1
            os._exit(code)
        self._snap_inflight = True

        def _reap() -> None:
            try:
                done_pid, status = os.waitpid(pid, os.WNOHANG)
                if done_pid == 0:
                    self.commit.defer(0.05, _reap)
                    return
                ok = os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0
            except ChildProcessError:
                # reaped elsewhere (a stray SIGCHLD handler): trust the
                # artifact, not the lost exit status
                ok = os.path.exists(os.path.join(
                    self.directory, f"snap-{floor:016d}.snap"))
            self._snap_inflight = False
            if ok:
                if self.metrics is not None:
                    self.metrics.counter("journal_snapshots").inc()
                    self.metrics.gauge("journal_snapshot_floor").set(floor)
                self._snap_floor = floor
                self.wal.drop_below(floor)
            else:
                print("[journal] snapshot child failed", file=sys.stderr)

        self.commit.defer(0.05, _reap)
        return True

    # -- surface -------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "wal": self.wal.stats(),
            "commit": self.commit.stats(),
            "replay": self.replay_stats,
            "snapshot_floor": self._snap_floor,
            "snapshot_every": self.snapshot_every,
            "registers": sum(len(r) for r in self._registers.values()),
            "bodies": len(self._bodies),
            "replied": len(self.replied),
            "replay_errors": self.replay_errors,
        }

    def close(self) -> None:
        try:
            # BLOCKING final flush: the async path would dispatch to the
            # worker and return, letting wal.close() mark the tail
            # durable without its fsync and close fds under the worker
            self.commit.flush(sync=True)
        finally:
            self.wal.close()


class JournaledKVDataStore(KVDataStore):
    """KVDataStore whose appends are journal facts: with this + the apply
    records, a fresh process recovers the exact value logs — the premise
    'the data store is durable' that Journal.restore() assumes becomes
    true across a real kill -9."""

    def __init__(self, node_id: int, journal: DurableJournal):
        super().__init__(node_id)
        self.journal = journal

    def apply_append(self, token, values, execute_at, txn_id) -> None:
        if not any(tid == txn_id
                   for _v, _at, tid in self.log.get(token, ())):
            self.journal.record_apply(token, values, execute_at, txn_id)
        super().apply_append(token, values, execute_at, txn_id)
