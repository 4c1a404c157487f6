"""Strict-serializability verification of client-observed results.

Rebuild of ref: accord-core/src/test/java/accord/verify/
StrictSerializabilityVerifier.java:58 (adapted to the list-append workload):
every client reply must be consistent with SOME total order of transactions
that (a) respects per-key list-prefix semantics and (b) respects real time —
if txn A completed before txn B began, A must not observe effects of B and B
must observe at least A's effects on any key both touch.

The list-append workload pins exact per-key step indices: appends are
uniquely tagged, so a read of key k that observed prefix P witnessed step
``len(P)`` of k's register, and a write whose value lands at position p in
the final order produced step ``p+1``.  That lets us rebuild the reference's
incremental max-predecessor graph as a post-hoc fixpoint over (key, step)
nodes instead of its intrusive-linked-list machinery.

Checks, in order of increasing strength:
  1. prefix consistency: every observed list is a prefix of the final list
     (no lost, reordered, or phantom appends);
  2. monotonic real time per key: if read R1 completed before R2 started,
     R1's observed prefix must be <= R2's;
  3. own-write visibility ordering: a txn that appended v after reading
     prefix P must have v at exactly position len(P) in the final order
     (read and write share one serialization point);
  4. cross-key cycles (ref StrictSerializabilityVerifier.java:58): per
     (key, step) node, propagate the maximum predecessor step reachable per
     key through the transitive closure of happens-before edges —
       (a) anything witnessed coincident with step s of key b precedes
           step s+1 of b;
       (b) reads coincident with a write precede the write's step —
     and flag a node that can reach itself.  This catches multi-key
     anomalies (e.g. write-skew style cycles) that every per-key check
     passes.  Real-time windows ride the same graph: each node carries the
     latest serialization lower bound (max start of any writer/predecessor
     witness) and earliest upper bound (min end of any witness); a node
     whose lower bound exceeds its upper bound is a real-time violation
     (ref Step.writtenAfter/writtenBefore/maxPredecessorWrittenAfter).
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

from ..utils import invariants

_NEG = float("-inf")
_POS = float("inf")


class HistoryViolation(AssertionError):
    pass


class _Observation:
    __slots__ = ("start", "end", "token", "prefix_len", "op_id")

    def __init__(self, start: int, end: int, token: int, prefix_len: int,
                 op_id: int):
        self.start = start
        self.end = end
        self.token = token
        self.prefix_len = prefix_len
        self.op_id = op_id


class StrictSerializabilityVerifier:
    """Collects client operations and verifies on demand."""

    def __init__(self):
        self._next_op = 0
        # per token: list of (observed prefix tuple, op)
        self.reads: List[_Observation] = []
        self.read_values: Dict[int, Dict[int, tuple]] = {}  # op_id -> token -> value
        self.writes: Dict[int, Dict[int, tuple]] = {}       # op_id -> token -> appended
        self.op_times: Dict[int, Tuple[int, int]] = {}
        self.finals: Dict[int, tuple] = {}

    def begin(self) -> int:
        op = self._next_op
        self._next_op += 1
        return op

    def on_result(self, op_id: int, start_micros: int, end_micros: int,
                  reads: Dict[int, tuple], appends: Dict[int, tuple]) -> None:
        self.op_times[op_id] = (start_micros, end_micros)
        self.read_values[op_id] = dict(reads)
        self.writes[op_id] = dict(appends)
        for token, value in reads.items():
            self.reads.append(_Observation(start_micros, end_micros, token,
                                           len(value), op_id))

    def set_final(self, token: int, value: tuple) -> None:
        self.finals[token] = value

    # -- checks -------------------------------------------------------------
    def verify(self) -> None:
        self._effective_finals = self._compute_effective_finals()
        self._check_prefixes()
        self._check_realtime()
        self._check_own_writes()
        self._check_cross_key()

    def _compute_effective_finals(self) -> Dict[int, tuple]:
        """The reference sequence per token used to pin step positions.
        A recorded quorum-read final is authoritative — a read observing
        beyond it is an anomaly that _check_prefixes must flag, so it is
        never extended.  For tokens whose final read failed (burn skips
        set_final there) the longest observation substitutes, but only as a
        PARTIAL final: checks that require completeness consult
        ``token in self.finals`` before trusting absence."""
        finals: Dict[int, tuple] = {}
        for reads in self.read_values.values():
            for token, observed in reads.items():
                cur = finals.get(token, ())
                if len(observed) > len(cur):
                    finals[token] = tuple(observed)
        finals.update(self.finals)
        return finals

    def _check_prefixes(self) -> None:
        """Every observed list must be a prefix of the (effective) final
        list; appended values must appear exactly once in the final list
        (ref Register.updateSequence 'Inconsistent sequences')."""
        for op_id, reads in self.read_values.items():
            for token, observed in reads.items():
                final = self._effective_finals.get(token)
                if final is None:
                    continue
                if tuple(final[:len(observed)]) != tuple(observed):
                    raise HistoryViolation(
                        f"op {op_id} read {observed} on key {token}, not a "
                        f"prefix of final {final}")
        for token, final in self._effective_finals.items():
            seen = {}
            for v in final:
                if v in seen:
                    raise HistoryViolation(
                        f"duplicate append {v!r} on key {token}: {final}")
                seen[v] = True

    def _check_realtime(self) -> None:
        """If op A ended before op B started, B must observe at least as long
        a prefix on any key both read (per-key real-time monotonicity).
        Plane sweep: walk observations by start time, holding a running max
        of prefixes among already-completed observations."""
        by_token: Dict[int, List[_Observation]] = {}
        for obs in self.reads:
            by_token.setdefault(obs.token, []).append(obs)
        for token, obss in by_token.items():
            by_start = sorted(obss, key=lambda o: o.start)
            by_end = sorted(obss, key=lambda o: o.end)
            done = 0            # index into by_end of next not-yet-counted op
            floor = 0           # max prefix among ops with end < current start
            floor_op = None
            for obs in by_start:
                while done < len(by_end) and by_end[done].end < obs.start:
                    if by_end[done].prefix_len > floor:
                        floor = by_end[done].prefix_len
                        floor_op = by_end[done].op_id
                    done += 1
                if obs.prefix_len < floor:
                    raise HistoryViolation(
                        f"real-time violation on key {token}: op {obs.op_id} "
                        f"(start {obs.start}) observed prefix {obs.prefix_len}"
                        f" < {floor} observed by earlier-completed op "
                        f"{floor_op}")

    def _check_own_writes(self) -> None:
        """A txn that read prefix P of key k and appended v must have v at
        exactly position len(P) in the final order: the read and the write
        share one serialization point (executeAt), so nothing can serialize
        between them on the same key."""
        for op_id, appends in self.writes.items():
            reads = self.read_values.get(op_id, {})
            for token, values in appends.items():
                final = self._effective_finals.get(token)
                if final is None or not values:
                    continue
                complete = token in self.finals
                for v in values:
                    if v not in final and complete:
                        raise HistoryViolation(
                            f"committed append {v!r} of op {op_id} missing "
                            f"from final {final} on key {token}")
                observed = reads.get(token)
                # position equality is valid even against a partial final:
                # positions inside any observed prefix are final positions
                if observed is not None and values[0] in final:
                    pos = final.index(values[0])
                    if pos != len(observed):
                        raise HistoryViolation(
                            f"op {op_id} appended {values[0]!r} at position "
                            f"{pos} but read a prefix of length "
                            f"{len(observed)} on key {token}")

    # -- cross-key max-predecessor graph ------------------------------------
    def _witnessed_steps(self, op_id: int):
        """(witness, read_step, wrote) for an op.

        witness: token -> the step index witnessed coincident with the op —
          for a read, the observed prefix length (+1 if the op also wrote
          the key: the write is part of the coincident observation, ref
          witnessRead's 'implicitly longer by one'); for a blind write, the
          step pinned by the value's position in the final order (the ref
          resolves these lazily via FutureWrites/UnknownStepHolder — the
          post-hoc formulation can use the final directly).
        read_step: token -> the step witnessed by the READ alone (excludes
          the op's own write).
        """
        reads = self.read_values.get(op_id, {})
        appends = self.writes.get(op_id, {})
        witness: Dict[int, int] = {}
        read_step: Dict[int, int] = {}
        for token, observed in reads.items():
            read_step[token] = len(observed)
            wrote = bool(appends.get(token))
            witness[token] = len(observed) + (1 if wrote else 0)
        for token, values in appends.items():
            if not values or token in witness:
                continue
            final = self._effective_finals.get(token)
            if final is None or values[0] not in final:
                continue    # unresolvable blind write (missing-final token)
            witness[token] = final.index(values[0]) + 1
        return witness, read_step, appends

    def _check_cross_key(self) -> None:
        """Propagate max predecessors across keys and flag self-reachable
        steps (cycles) and real-time window inversions
        (ref StrictSerializabilityVerifier.java:58, Step.onChange)."""
        # -- build the happens-before edge set over (token, step) nodes
        edges = set()
        witnessed_until: Dict[Tuple[int, int], float] = {}
        written_before: Dict[Tuple[int, int], float] = {}
        written_after: Dict[Tuple[int, int], float] = {}

        for op_id, (start, end) in self.op_times.items():
            witness, read_step, appends = self._witnessed_steps(op_id)
            for token, s in witness.items():
                node = (token, s)
                if start > witnessed_until.get(node, _NEG):
                    witnessed_until[node] = start
                if end < written_before.get(node, _POS):
                    written_before[node] = end
                if appends.get(token) and start > written_after.get(node, _NEG):
                    written_after[node] = start
            # (a) anything witnessed coincident with step s_b of key b
            #     precedes step s_b+1 of b (ref Step.updatePeers +
            #     receiveKnowledgePhasedPredecessors via maxPeers)
            items = list(witness.items())
            for a, sa in items:
                for b, sb in items:
                    if a != b:
                        edges.add(((a, sa), (b, sb + 1)))
            # (b) keys only read precede the keys written by the same txn
            #     (ref Step.updatePredecessorsOfWrite)
            for b in appends:
                sb = witness.get(b)
                if sb is None or not appends[b]:
                    continue
                for a, ra in read_step.items():
                    if a != b:
                        edges.add(((a, ra), (b, sb)))

        # intra-key register order: (k, i) -> (k, i+1)
        max_step: Dict[int, int] = {}
        for (t, s) in (n for e in edges for n in e):
            if s > max_step.get(t, 0):
                max_step[t] = s
        for node in witnessed_until:
            t, s = node
            if s > max_step.get(t, 0):
                max_step[t] = s
        for t, final in self._effective_finals.items():
            if len(final) > max_step.get(t, 0):
                max_step[t] = len(final)
        for t, m in max_step.items():
            for i in range(m):
                edges.add(((t, i), (t, i + 1)))
                # a step is written after anything that witnessed its
                # direct predecessor state (ref propagateToDirectSuccessor)
                wu = witnessed_until.get((t, i))
                if wu is not None and wu > written_after.get((t, i + 1), _NEG):
                    written_after[(t, i + 1)] = wu

        # -- fixpoint: max predecessor per key + folded lower time bounds.
        # Monotone (steps and times only increase, both bounded), so a plain
        # worklist converges; this subsumes the ref's intrusive back-link
        # refresh queue.
        out_edges = defaultdict(list)
        for u, v in edges:
            out_edges[u].append(v)
        maxpred: Dict[Tuple[int, int], Dict[int, int]] = defaultdict(dict)
        lower = dict(written_after)   # serialization-point lower bounds
        work = deque(out_edges.keys())
        queued = set(work)
        while work:
            u = work.popleft()
            queued.discard(u)
            tu, su = u
            mu = maxpred.get(u)
            lu = lower.get(u, _NEG)
            for v in out_edges[u]:
                mv = maxpred[v]
                changed = False
                if mu:
                    for k, s in mu.items():
                        if mv.get(k, -1) < s:
                            mv[k] = s
                            changed = True
                if mv.get(tu, -1) < su:
                    mv[tu] = su
                    changed = True
                if lu > lower.get(v, _NEG):
                    lower[v] = lu
                    changed = True
                if changed and v not in queued and v in out_edges:
                    work.append(v)
                    queued.add(v)
            # nodes with no outgoing edges still get checked below

        for node, mp in maxpred.items():
            t, s = node
            if mp.get(t, -1) >= s:
                raise HistoryViolation(
                    f"cross-key cycle: key {t} step {s} reaches itself "
                    f"through happens-before relations (max predecessors "
                    f"{mp})")
        for node, lo in lower.items():
            hi = written_before.get(node, _POS)
            if lo > hi:
                t, s = node
                raise HistoryViolation(
                    f"real-time inversion on key {t} step {s}: must have "
                    f"been written after {lo} (a predecessor's bound) but "
                    f"was witnessed complete by {hi}")
