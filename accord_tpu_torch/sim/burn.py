"""The burn test: deterministic chaos simulation.

Rebuild of ref: accord-core/src/test/java/accord/burn/BurnTest.java:108 +
impl/basic/Cluster.java:102.  One seeded RandomSource drives:

- a random multi-key list-append workload from random coordinators at random
  simulated times (zipf-ish key skew);
- network chaos re-randomized periodically: partitions + message drops over
  the simulated links (ref: NodeSink DELIVER/DROP, Cluster.java:518-630);
- per-node clock drift: each node's local clock runs at a distinct rational
  rate with a distinct offset (ref: BurnTest.java:330-340 FrequentLargeRange);
- topology churn: periodic epochs shuffling membership/shard counts
  (ref: topology/TopologyRandomizer.java:58-115);
- simulated persistence: random node crash-restarts reconstructing state
  from the journal, plus random command eviction/reload
  (ref: impl/basic/Journal.java:82-171, DelayedCommandStores.java:96-175);
- strict-serializability verification of every client-observed result plus
  end-of-run accounting that every op resolved
  (ref: verify/StrictSerializabilityVerifier.java, BurnTest.java:480-499).

The whole run is a pure function of (seed, parameters): same seed, same
message counts, same results — which is itself the race detector
(ref: burn/ReconcilingLogger same-seed diffing).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

from ..topology.topology import Topology
from ..utils.random_source import RandomSource
from .cluster import Cluster
from .kvstore import (KVDataStore, kv_ephemeral_read, kv_range_read, kv_txn)
from .topology_factory import build_topology, mutate_electorates
from .elle import CompositeVerifier, ListAppendCycleChecker
from .verifier import StrictSerializabilityVerifier


class BurnResult:
    def __init__(self):
        self.ops_ok = 0
        self.ops_failed = 0
        self.ops_unresolved = 0
        self.epochs = 1
        self.restarts = 0
        self.evictions = 0
        self.stats: Dict[str, int] = {}
        # post-chaos quiescence gate (ref BurnTest.java:480-499): recovery
        # traffic observed in a silent window after the drain, and whether
        # every op resolved within the bounded drain
        self.quiet_recovery_msgs = 0
        self.drain_micros_used = 0
        self.kernel_wall: Dict[str, float] = {}   # wall timings (not seeded)
        # unified observability exports (obs.*): the registry snapshot is a
        # pure function of the seed (sim-time stamps only) and the span
        # export is the canonical byte string same-seed runs must reproduce
        # exactly; span_export is None under ACCORD_TPU_OBS=off
        self.metrics_snapshot: Optional[Dict] = None
        self.span_export: Optional[str] = None
        self.fast_path_rate: Optional[float] = None
        self.phase_latencies: Dict[str, Dict[str, int]] = {}
        # black-box flight recorder (obs.flight): canonical JSON of every
        # anomaly post-mortem bundle this run dumped — byte-identical
        # across same-seed runs (None under ACCORD_TPU_OBS=off)
        self.flight_export: Optional[str] = None
        self.flight_postmortems = 0
        # r14 recovery-under-chaos: recovery lifecycle totals (attempt /
        # executed / applied / invalidated / preempted / timeout /
        # truncated, from coordinate.recover's counters) and, when the
        # nemesis is armed, its per-leg fire counts — both also mirrored
        # into ``stats`` so the same-seed determinism gates compare them
        self.recoveries: Dict[str, int] = {}
        self.nemesis: Dict[str, int] = {}
        # r17 serving-shaped churn: per-planner fire counts (add /
        # remove / move via net.reconfig's plan functions — the exact
        # operations the TCP reconfigure verb proposes), mirrored into
        # ``stats`` like the nemesis legs
        self.reconfig_churn: Dict[str, int] = {}

    def __repr__(self):
        return (f"BurnResult(ok={self.ops_ok}, failed={self.ops_failed}, "
                f"unresolved={self.ops_unresolved}, epochs={self.epochs}, "
                f"restarts={self.restarts}, evictions={self.evictions})")


def run_burn(seed: int, n_ops: int = 100, n_keys: int = 20,
             node_ids=(1, 2, 3, 4, 5), rf: int = 3, shards: int = 4,
             workload_micros: int = 20_000_000,
             chaos: bool = True, churn: bool = True, restarts: bool = True,
             drain_micros: int = 120_000_000,
             probe=None, probe_micros: int = 0,
             boundary_churn_only: bool = False,
             device_faults: Optional[str] = None,
             device_fault_p: float = 0.05,
             recovery_nemesis: bool = False,
             reconfig_churn: bool = False,
             device="cuda", mesh="auto") -> BurnResult:
    if device_faults is not None:
        # DEVICE-FAULT NEMESIS: arm the accelerator-boundary fault
        # registry (utils.faults) for the whole run — one fault class, or
        # "all".  The fault stream is seeded from the run seed WITHOUT
        # touching ``rs``, so the protocol/chaos randomness — and therefore
        # deps_found and every client-visible outcome — is byte-identical
        # to the fault-free run at the same seed (the quarantine ->
        # host-fallback ladder in local.device_index absorbs every fault).
        # Paranoia mode rides along: it is the detector for stale_result.
        from ..utils import faults
        kinds = sorted(faults.DEVICE_FAULT_KINDS) if device_faults == "all" \
            else [device_faults]
        frng = RandomSource((seed << 8) ^ 0xFA17)
        prior_paranoia = faults.PARANOIA
        try:
            for k in kinds:
                faults.inject_device_fault(k, device_fault_p, frng.fork())
            faults.PARANOIA = True
            return run_burn(seed, n_ops=n_ops, n_keys=n_keys,
                            node_ids=node_ids, rf=rf, shards=shards,
                            workload_micros=workload_micros, chaos=chaos,
                            churn=churn, restarts=restarts,
                            drain_micros=drain_micros, probe=probe,
                            probe_micros=probe_micros,
                            boundary_churn_only=boundary_churn_only,
                            recovery_nemesis=recovery_nemesis,
                            reconfig_churn=reconfig_churn, device=device,
                            mesh=mesh)
        finally:
            faults.PARANOIA = prior_paranoia
            for k in kinds:
                faults.clear_device_faults(k)
    rs = RandomSource(seed)
    topology = build_topology(1, node_ids, rf, shards)
    cluster = Cluster(topology=topology, seed=rs.next_int(1 << 30),
                      data_store_factory=KVDataStore,
                      # journal-backed paging: terminal commands beyond this
                      # per-store count page out and reload on demand
                      paged_limit=150,
                      # torch device (and mesh) of every store's device
                      # plane
                      device=device, mesh=mesh)
    # composite verification (ref: verify/CompositeVerifier.java): the
    # real-time-anchored checker AND the independent Elle-style dependency-
    # cycle checker both pass, or the run fails with the dissenting
    # checker's witness
    verifier = CompositeVerifier(StrictSerializabilityVerifier(),
                                 ListAppendCycleChecker())
    result = BurnResult()
    wl = rs.fork()           # workload randomness
    net = rs.fork()          # chaos randomness
    top = rs.fork()          # churn randomness

    # per-node clock drift: ±1% rate + up to 2s initial offset — orders of
    # magnitude beyond real crystal drift, enough to exercise every
    # HLC-merge/fence path without drowning the run in slow paths
    # (ref: BurnTest.java:330-340 FrequentLargeRange)
    drift = rs.fork()
    for nid in node_ids:
        cluster.clock_drift[nid] = (990 + drift.next_int(21), 1000,
                                    drift.next_int(2_000_000))

    # hot-key skew: a few keys get most of the traffic
    hot = [wl.next_int(n_keys) for _ in range(max(2, n_keys // 5))]

    def pick_key() -> int:
        if wl.decide(0.5):
            return hot[wl.next_int(len(hot))] * 10
        return wl.next_int(n_keys) * 10

    outstanding: List[dict] = []

    def submit_op(op_seed: int):
        from ..primitives.keys import Range, Ranges
        node_id = sorted(cluster.nodes)[wl.next_int(len(cluster.nodes))]
        roll = wl.next_float()
        window = None
        if roll < 0.06:
            # non-durable single-key linearizable read
            # (ref: the burn's EphemeralRead mix, BurnTest.java:124-259)
            keys = [pick_key()]
            writes = {}
            txn = kv_ephemeral_read(keys)
        elif roll < 0.14:
            # range-domain read over a zipf-ish key window
            lo = wl.next_int(n_keys)
            hi = min(n_keys, lo + 1 + wl.next_int(4))
            window = [k * 10 for k in range(lo, hi)]
            keys, writes = window, {}
            txn = kv_range_read(Ranges.of(Range(lo * 10, hi * 10)))
        else:
            n = wl.next_int(3) + 1
            keys = sorted({pick_key() for _ in range(n)})
            writes = {}
            for k in keys:
                if wl.decide(0.6):
                    writes[k] = (f"s{op_seed}k{k}",)
            txn = kv_txn(keys, writes)
        op = {"id": verifier.begin(), "start": cluster.queue.now,
              "done": False, "writes": writes, "keys": keys, "node": node_id}
        outstanding.append(op)

        def attempt(attempt_no: int, txn, node_id: int):
            op["node"] = node_id

            def on_done(res, failure):
                if op["done"]:
                    return   # already counted lost (coordinator restarted)
                if failure is not None:
                    # a real client retries a failed op (fresh txn, fresh
                    # value tags — the failed attempt's write may still land
                    # as its own committed txn, which the verifier's prefix
                    # checks accommodate).  Bounded: reported-failure
                    # windows (DELIVER_WITH_FAILURE) otherwise surface
                    # most of a window's ops as client failures.
                    if attempt_no < 3 and cluster.queue.now < \
                            workload_micros + drain_micros // 2:
                        if writes:
                            retag = {k: (f"s{op_seed}a{attempt_no}k{k}",)
                                     for k in writes}
                            retry_txn = kv_txn(keys, retag)
                        else:
                            retry_txn = txn   # reads retry verbatim
                        nxt = sorted(cluster.nodes)[
                            wl.next_int(len(cluster.nodes))]
                        attempt(attempt_no + 1, retry_txn, nxt)
                        return
                    op["done"] = True
                    result.ops_failed += 1
                    return
                op["done"] = True
                result.ops_ok += 1
                reads = res.reads
                if window is not None:
                    # a range read observing nothing on a window key
                    # observed the empty prefix — record it so real-time
                    # checks bite
                    reads = {t: res.reads.get(t, ()) for t in window}
                verifier.on_result(op["id"], op["start"], cluster.queue.now,
                                   reads, res.appends)

            cluster.nodes[node_id].coordinate(txn).begin(on_done)

        attempt(0, txn, node_id)

    # schedule the workload across the window
    for i in range(n_ops):
        at = wl.next_int(workload_micros)
        cluster.queue.add(at, lambda i=i: submit_op(i))

    # chaos: re-randomize partitions / drops every 2s of sim time
    def shake():
        cluster.heal()
        cluster.drop_probability = 0.0
        cluster.deliver_with_failure_probability = 0.0
        cluster.failure_probability = 0.0
        if cluster.queue.now > workload_micros:
            return
        roll = net.next_int(10)
        nodes = sorted(cluster.nodes)
        if roll < 3 and len(nodes) >= 3:
            a, b = net.pick(nodes), net.pick(nodes)
            if a != b:
                cluster.partition(a, b)
        elif roll < 5:
            cluster.drop_probability = 0.05 + 0.1 * net.next_float()
        elif roll < 7:
            # delivered-but-reported-failed + fast-failure windows: the
            # duplicate-coordination trigger (ref: NodeSink.java:46
            # DELIVER_WITH_FAILURE / FAILURE)
            cluster.deliver_with_failure_probability = \
                0.02 + 0.04 * net.next_float()
            cluster.failure_probability = 0.01 + 0.03 * net.next_float()
        cluster.queue.add(cluster.queue.now + 2_000_000, shake)

    if chaos:
        cluster.queue.add(2_000_000, shake)

    if probe is not None:
        # diagnostics hook: inspect live cluster state at a fixed sim time
        cluster.queue.add(probe_micros, lambda: probe(cluster))

    # topology churn: a few epochs during the workload
    def churn_once():
        """INCREMENTAL topology mutation (ref: topology/TopologyRandomizer
        .java:58-115 — one SPLIT/MERGE/MEMBERSHIP change per epoch).  The
        reference's randomizer never hands the whole ring over at once: a
        wholesale swap leaves every new owner bootstrapping simultaneously,
        which no real reconfiguration produces and which starves reads of
        any serving replica."""
        if cluster.queue.now > workload_micros:
            return
        # don't stack reconfigurations: churning while the previous epoch's
        # data is still migrating compounds bootstrap fences across nodes
        # into dependency cycles (no operator/controller reconfigures a
        # cluster mid-rebalance; the reference randomizer's 1s cadence is
        # effectively gated the same way by its instant in-memory fetches)
        if any(not s.bootstrapping.is_empty()
               for node in cluster.nodes.values()
               for s in node.command_stores.unsafe_all_stores()):
            cluster.queue.add(cluster.queue.now + 2_000_000, churn_once)
            return
        current = cluster.topologies[-1]
        all_ids = list(node_ids)
        members = sorted(current.nodes())
        roll = 4 + top.next_int(3) if boundary_churn_only \
            else top.next_int(7)
        if roll >= 4:
            # arbitrary shard-boundary mutation (ref: TopologyRandomizer
            # .java:427 SPLIT/MERGE/MOVE): one boundary changes while every
            # other shard is untouched — the partial-bootstrap shapes a
            # uniform ring re-split never produces
            from .topology_factory import (merge_shards, move_boundary,
                                           split_shard)
            mut = (split_shard, merge_shards, move_boundary)[roll - 4]
            topo = mut(current, top, current.epoch + 1)
            cluster.add_topology(topo)
            result.epochs += 1
            cluster.queue.add(cluster.queue.now + 4_000_000
                              + top.next_int(4_000_000), churn_once)
            return
        if roll == 0 and len(members) < len(all_ids):
            # membership: add one node
            members = sorted(members + [top.pick(
                [n for n in all_ids if n not in members])])
        elif roll == 1 and len(members) > max(3, rf):
            # membership: drop one node
            members = [n for n in members if n != top.pick(members)]
        # roll 2: keep members, reshard only; roll 3: FASTPATH (below)
        # keep the run's replication degree through churn (ref: the
        # TopologyRandomizer varies rf 2..9, BurnTest.java:600-609) — capping
        # at 3 silently collapsed every big-cluster run's geometry at the
        # first epoch change
        new_rf = min(rf, len(members))
        prev_shards = len(current.shards)
        # the shard-count cap follows the run's configuration (same defect
        # class as the old rf<=3 cap: a shards=6 run must keep exercising
        # 6-shard geometry through churn, not collapse to 5 at epoch 2)
        new_shards = max(2, min(max(5, shards),
                                prev_shards + top.next_int(3) - 1))
        topo = build_topology(current.epoch + 1, members, new_rf, new_shards)
        if roll == 3:
            # mutate the fast-path electorate (ref: TopologyRandomizer
            # FASTPATH action): shrink electorates within legal bounds so
            # fast-path quorum math is exercised off the everyone-votes
            # default through the rest of the run
            topo = mutate_electorates(topo, top)
        cluster.add_topology(topo)
        result.epochs += 1
        cluster.queue.add(cluster.queue.now + 4_000_000 + top.next_int(4_000_000),
                          churn_once)

    if churn:
        cluster.queue.add(4_000_000 + top.next_int(2_000_000), churn_once)

    # background durability rounds at randomized rates (ref: burn wires
    # CoordinateDurabilityScheduling with randomized frequencies,
    # Cluster.java:302-372): these advance the watermarks that drive
    # truncation, keeping per-store state bounded
    dur = rs.fork()

    def durability_round():
        # runs through the drain (durability advancing is how home
        # progress-log entries retire — stopping at drain/2 left
        # legitimate not-yet-durable entries probing forever, which the
        # quiescence gate would misread as a leak) but stands down once
        # every client op resolved, so the drain loop's early-exit (all
        # done AND queue empty) stays reachable
        if cluster.queue.now > workload_micros + drain_micros:
            return
        if cluster.queue.now > workload_micros \
                and all(op["done"] for op in outstanding):
            return
        nid = sorted(cluster.nodes)[dur.next_int(len(cluster.nodes))]
        sched = cluster.durability.get(nid)
        if sched is not None:
            if dur.decide(0.8):
                sched.shard_tick()
            else:
                sched.global_tick()
        cluster.queue.add(cluster.queue.now + 500_000 +
                          dur.next_int(1_500_000), durability_round)

    cluster.queue.add(1_000_000 + dur.next_int(1_000_000), durability_round)

    # simulated persistence chaos: node crash-restarts (journal restore) and
    # random command eviction/reload (ref: the burn's Journal +
    # DelayedCommandStores random isLoadedCheck evictions)
    rst = rs.fork()

    def crash_node(nid: int) -> None:
        # the crash kills the node's client sessions: their ops become
        # indeterminate for the client (not fed to the verifier) — shared
        # by the ambient restarts and the recovery nemesis's kill leg so
        # crash accounting can never diverge between them
        for op in outstanding:
            if not op["done"] and op["node"] == nid:
                op["done"] = True
                result.ops_failed += 1
        cluster.restart_node(nid)
        result.restarts += 1

    def maybe_restart():
        if cluster.queue.now > workload_micros:
            return
        crash_node(sorted(cluster.nodes)[rst.next_int(len(cluster.nodes))])
        cluster.queue.add(cluster.queue.now + 6_000_000 +
                          rst.next_int(6_000_000), maybe_restart)

    def evict_tick():
        if cluster.queue.now > workload_micros:
            return
        nid = sorted(cluster.nodes)[rst.next_int(len(cluster.nodes))]
        node = cluster.nodes[nid]
        journal = cluster.journals[nid]
        for store in node.command_stores.unsafe_all_stores():
            txn_ids = sorted(store.commands)
            for _ in range(min(3, len(txn_ids))):
                tid = txn_ids[rst.next_int(len(txn_ids))]
                journal.evict_and_reload(store, tid)
                result.evictions += 1
        cluster.queue.add(cluster.queue.now + 1_500_000 +
                          rst.next_int(1_000_000), evict_tick)

    if restarts:
        cluster.queue.add(4_000_000 + rst.next_int(4_000_000), maybe_restart)
        cluster.queue.add(1_000_000 + rst.next_int(1_000_000), evict_tick)

    # RECOVERY-UNDER-CHAOS NEMESIS (r14, ISSUE 10): aim chaos AT live
    # recoveries instead of around them.  The cluster records the most
    # recent BeginRecovery it routed (coordinator, txn, route); each tick
    # fires one leg at it:
    #   kill      — crash-restart the recovery coordinator mid-recovery
    #               (its promise ballot dies with it; peers must re-recover)
    #   partition — cut the coordinator off from part of its recovery
    #               quorum for a window, then heal
    #   race      — start a SECOND concurrent recoverer for the same txn
    #               from another node (the ballot race: exactly one wins,
    #               the loser must observe Preempted, never a double apply)
    # The stream is a dedicated fork appended after every existing fork,
    # so arming the nemesis perturbs no other stream and a nemesis-off run
    # is byte-identical to r13.  Composes with --device-faults.
    nem = rs.fork()

    def nemesis_tick():
        if cluster.queue.now > workload_micros:
            return
        seen = cluster.last_recovery
        if seen is not None:
            cluster.last_recovery = None   # each observation drives one leg
            src, txn_id, route = seen
            leg = nem.next_int(3)
            if leg == 0 and src in cluster.nodes:
                crash_node(src)
                result.nemesis["kill"] = result.nemesis.get("kill", 0) + 1
            elif leg == 1:
                others = [n for n in sorted(cluster.nodes) if n != src]
                if others:
                    other = others[nem.next_int(len(others))]
                    cluster.partition(src, other)
                    pair = frozenset((src, other))
                    cluster.queue.add(
                        cluster.queue.now + 1_500_000,
                        lambda p=pair: cluster.partitioned.discard(p))
                    result.nemesis["partition"] = \
                        result.nemesis.get("partition", 0) + 1
            else:
                others = [n for n in sorted(cluster.nodes) if n != src]
                if others:
                    other = others[nem.next_int(len(others))]
                    cluster.nodes[other].recover(txn_id, route).begin(
                        lambda r, f: None)   # Preempted losses are the point
                    result.nemesis["race"] = \
                        result.nemesis.get("race", 0) + 1
        cluster.queue.add(cluster.queue.now + 1_200_000
                          + nem.next_int(800_000), nemesis_tick)

    if recovery_nemesis:
        cluster.queue.add(3_000_000 + nem.next_int(1_000_000), nemesis_tick)

    # SERVING-SHAPED EPOCH CHURN (r17, elastic serving): drive the EXACT
    # reconfiguration operations the TCP ``reconfigure`` verb proposes —
    # net.reconfig.plan_join / plan_leave / plan_move, pure functions of
    # the current topology — through the sim's deterministic delivery,
    # composed with the recovery nemesis and device faults (membership
    # change racing recovery racing kill -9: the Jepsen scenario class).
    # The stream is a dedicated fork appended after EVERY existing fork
    # (wl, net, top, drift, dur, rst, nem), so arming it perturbs no
    # other stream and a churn-off run is byte-identical to r16.
    rcf = rs.fork()

    def reconfig_tick():
        if cluster.queue.now > workload_micros:
            return
        # the operator no-stacking guard (the TCP verb rejects the same
        # way): never propose while a rebalance is migrating data
        if any(not s.bootstrapping.is_empty()
               for node in cluster.nodes.values()
               for s in node.command_stores.unsafe_all_stores()):
            cluster.queue.add(cluster.queue.now + 2_000_000, reconfig_tick)
            return
        from ..net.reconfig import plan_join, plan_leave, plan_move
        current = cluster.topologies[-1]
        members = sorted(current.nodes())
        absent = [n for n in node_ids if n not in members]
        roll = rcf.next_int(3)
        if roll == 0 and absent:
            leg, topo = "add", plan_join(current, rcf.pick(absent),
                                         current.epoch + 1)
        elif roll == 1 and len(members) > max(3, rf):
            leg, topo = "remove", plan_leave(current, rcf.pick(members),
                                             current.epoch + 1)
        else:
            shard = current.shards[rcf.next_int(len(current.shards))]
            leg, topo = "move", plan_move(current, shard.range.start,
                                          members[rcf.next_int(
                                              len(members))],
                                          current.epoch + 1)
        cluster.add_topology(topo)
        result.epochs += 1
        result.reconfig_churn[leg] = result.reconfig_churn.get(leg, 0) + 1
        cluster.queue.add(cluster.queue.now + 5_000_000
                          + rcf.next_int(3_000_000), reconfig_tick)

    if reconfig_churn:
        cluster.queue.add(4_500_000 + rcf.next_int(1_500_000),
                          reconfig_tick)

    # run the workload window + drain until every op resolves
    cluster.run_for(workload_micros)
    cluster.heal()
    cluster.drop_probability = 0.0
    deadline = cluster.queue.now + drain_micros
    while cluster.queue.now < deadline:
        if all(op["done"] for op in outstanding) and cluster.queue.is_empty():
            break
        fn = cluster.queue.pop()
        if fn is None:
            break
        fn()

    result.ops_unresolved = sum(1 for op in outstanding if not op["done"])
    result.drain_micros_used = max(0, cluster.queue.now - workload_micros)

    # post-chaos QUIESCENCE GATE (ref: BurnTest.java:480-499): chaos and
    # workload have stopped and every surviving op resolved — run a silent
    # window and count recovery/fetch traffic.  A healthy cluster decays to
    # idle; a slow liveness leak (progress logs grinding, recovery loops)
    # shows up as sustained CheckStatus/BeginRecovery flow and fails the
    # endurance legs' gate.
    quiet_before = dict(cluster.stats)
    cluster.run_for(10_000_000)
    for verb in ("CheckStatus", "BeginRecovery", "WaitOnCommit",
                 "InformOfTxnId", "AcceptInvalidate"):
        result.quiet_recovery_msgs += (cluster.stats.get(verb, 0)
                                       - quiet_before.get(verb, 0))

    # final reads: quorum-read every key from a live member and pin finals
    member = sorted(cluster.topologies[-1].nodes())[0]
    for k in range(n_keys):
        token = k * 10
        out: List[Tuple[object, Optional[BaseException]]] = []
        cluster.nodes[member].coordinate(kv_txn([token], {})).begin(
            lambda r, f: out.append((r, f)))
        cluster.run_until_quiescent()
        if out and out[0][1] is None:
            verifier.set_final(token, out[0][0].reads[token])

    if cluster.failures:
        raise AssertionError(f"seed {seed}: node-level failures: "
                             f"{cluster.failures[:3]}")
    verifier.verify()
    result.stats = dict(cluster.stats)
    # lived kernel batching: mean deps-scan batch size across all stores
    # (store-level coalescing; 1.0 would mean every query dispatched alone)
    nq = nd = ndeps = nfb = nff = nft = 0
    kt: Dict[str, float] = {}
    for node in cluster.nodes.values():
        disp = getattr(node, "dispatcher", None)
        if disp is not None:
            nff += disp.n_fused_launches
            nft += disp.n_fused_tick_launches
        for s in node.command_stores.unsafe_all_stores():
            if s.device is not None:
                nq += s.device.n_queries
                nd += s.device.n_dispatches
                ndeps += s.device.n_kernel_deps
                nfb += s.device.n_fallback_queries
                for k, (_c, sec) in s.device.kernel_times.items():
                    kt[k] = kt.get(k, 0.0) + sec
    result.stats["device_queries"] = nq
    result.stats["device_dispatches"] = nd
    # r08 launch coalescing: fused cross-store launches (flush / tick)
    # this run's dispatchers performed — like the routing mix, a cost-model
    # outcome, so the fault-equivalence gate strips it (a quarantined store
    # cannot fuse) while the determinism double-run still compares it
    result.stats["device_fused_launches"] = nff
    result.stats["device_fused_tick_launches"] = nft
    # total exact (query, dep) pairs the deps scans produced: identical
    # across routes by construction, so a device-fault run must report the
    # SAME number as the fault-free run at the same seed — the burn-level
    # bit-equivalence gate for the degradation ladder
    result.stats["deps_found"] = ndeps
    result.stats["device_fallback_queries"] = nfb
    # wall-clock timings live OUTSIDE stats: stats must stay a pure
    # function of the seed (the determinism double-run compares it)
    result.kernel_wall = {k: round(1e3 * sec, 1) for k, sec in kt.items()}

    # unified observability export (obs.*): fold every store's attribute
    # counters into the registry as labeled gauges, then snapshot — the
    # one deterministic record the double-run gate compares byte-for-byte
    # — and export the span trees (sim-time stamped, canonical JSON)
    from ..obs.metrics import collect_device_state
    for nid in sorted(cluster.nodes):
        for s in cluster.nodes[nid].command_stores.unsafe_all_stores():
            if s.device is not None:
                collect_device_state(cluster.obs.metrics, s.device,
                                     node=nid, store=s.store_id)
    result.metrics_snapshot = cluster.obs.metrics.snapshot()
    spans = cluster.obs.spans
    if spans is not None:
        result.span_export = spans.export_json()
        result.fast_path_rate = spans.fast_path_rate()
        result.phase_latencies = cluster.obs.metrics.phase_percentiles()
    flight = cluster.obs.flight
    if flight is not None:
        result.flight_export = flight.export_json()
        result.flight_postmortems = len(flight)
    # recovery lifecycle totals + nemesis leg counts ride the stats dict so
    # the same-seed double-run compares them byte-for-byte like everything
    # else (all sourced from sim-deterministic counters)
    result.recoveries = cluster.obs.metrics.counter_totals("recoveries",
                                                           by="event")
    for ev, n in sorted(result.recoveries.items()):
        result.stats[f"Recovery.{ev}"] = n
    for leg, n in sorted(result.nemesis.items()):
        result.stats[f"RecoveryNemesis.{leg}"] = n
    for leg, n in sorted(result.reconfig_churn.items()):
        result.stats[f"ReconfigChurn.{leg}"] = n
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description="accord_tpu_torch burn test")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-c", "--count", type=int, default=1)
    p.add_argument("-o", "--ops", type=int, default=100)
    p.add_argument("--loop-seed", type=int, default=None,
                   help="run seeds loop-seed, loop-seed+1, ... forever")
    p.add_argument("--no-chaos", action="store_true")
    p.add_argument("--no-churn", action="store_true")
    p.add_argument("--no-restarts", action="store_true")
    p.add_argument("--device-faults", default=None,
                   help="inject one accelerator fault class for the whole "
                        "run: kernel_launch | transfer | hbm_oom | "
                        "stale_result | all")
    p.add_argument("--device-fault-p", type=float, default=0.05,
                   help="per-boundary-crossing fault probability")
    p.add_argument("--recovery-nemesis", action="store_true",
                   help="aim chaos at live recoveries: coordinator kill "
                        "mid-recovery, partition/heal around the recovery "
                        "quorum, concurrent-recoverer ballot races")
    p.add_argument("--reconfig-churn", action="store_true",
                   help="serving-shaped epoch churn: add/remove/move "
                        "epochs via the SAME net.reconfig planners the "
                        "TCP reconfigure verb proposes (dedicated RNG "
                        "fork appended last; composes with "
                        "--recovery-nemesis and --device-faults)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the device plane: cuda (default) "
                        "or cpu")
    args = p.parse_args(argv)

    if args.loop_seed is not None:
        seed = args.loop_seed
        while True:
            r = run_burn(seed, n_ops=args.ops, chaos=not args.no_chaos,
                         churn=not args.no_churn,
                         restarts=not args.no_restarts,
                         device_faults=args.device_faults,
                         device_fault_p=args.device_fault_p,
                         recovery_nemesis=args.recovery_nemesis,
                         reconfig_churn=args.reconfig_churn,
                         device=args.device)
            print(f"seed {seed}: {r}")
            seed += 1
    start = args.seed if args.seed is not None else 0
    for seed in range(start, start + args.count):
        r = run_burn(seed, n_ops=args.ops, chaos=not args.no_chaos,
                     churn=not args.no_churn, restarts=not args.no_restarts,
                     device_faults=args.device_faults,
                     device_fault_p=args.device_fault_p,
                     recovery_nemesis=args.recovery_nemesis,
                     reconfig_churn=args.reconfig_churn,
                     device=args.device)
        print(f"seed {seed}: {r}")


if __name__ == "__main__":
    main()
