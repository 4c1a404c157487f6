"""Independent second verifier: Elle-style list-append dependency-cycle
checking (ref: accord-core/src/test/java/accord/verify/ElleVerifier.java,
which shells out to jepsen's Elle; clojure is unreachable in this
environment, so this is a self-contained reimplementation of Elle's
list-append analysis: build the wr/ww/rw dependency graph from uniquely
tagged appends and detect G1a-style phantom reads plus G1c / G-single / G2
cycles via SCC).

Deliberately DISJOINT strengths from sim.verifier.StrictSerializability-
Verifier: this checker knows nothing about real time — it condemns pure
data-dependency cycles among possibly-concurrent transactions; the other
checker anchors serialization points against real-time windows.  The
composite (CompositeVerifier, ref verify/CompositeVerifier.java) runs both;
a history must satisfy each.

Edge semantics over the per-key final append order F_k (every append is
uniquely tagged, so writers are unambiguous — Elle's core trick):
  wr: the writer of the LAST element of an observed prefix precedes the
      reader;
  ww: the writer of F_k[i] precedes the writer of F_k[i+1];
  rw: a reader that observed prefix length n anti-depends-on (precedes)
      the writer of F_k[n] — it serialized before that append landed.

Cycle classification (Adya): a cycle in wr∪ww alone is G1c; a cycle with
exactly one rw edge is G-single; more than one rw is G2 — all are
serializability violations for this workload and all fail verify().
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .verifier import HistoryViolation


class ListAppendCycleChecker:
    """Same feed API as StrictSerializabilityVerifier (begin / on_result /
    set_final / verify)."""

    def __init__(self):
        self._next_op = 0
        self.reads: Dict[int, Dict[int, tuple]] = {}
        self.writes: Dict[int, Dict[int, tuple]] = {}
        self.finals: Dict[int, tuple] = {}

    def begin(self) -> int:
        op = self._next_op
        self._next_op += 1
        return op

    def on_result(self, op_id: int, start_micros: int, end_micros: int,
                  reads: Dict[int, tuple], appends: Dict[int, tuple]) -> None:
        self.reads[op_id] = dict(reads)
        self.writes[op_id] = dict(appends)

    def set_final(self, token: int, value: tuple) -> None:
        self.finals[token] = tuple(value)

    # -- analysis -----------------------------------------------------------
    def _writer_index(self):
        """token -> {value: (position, writer op)}; None writer = the value
        landed but its op never reported success (indeterminate client
        outcome) — edges touching it still hold, with the landed position."""
        writer_of: Dict[Tuple[int, str], int] = {}
        for op, appends in self.writes.items():
            for token, values in appends.items():
                for v in values:
                    writer_of[(token, v)] = op
        index: Dict[int, Dict[str, Tuple[int, Optional[int]]]] = {}
        for token, final in self.finals.items():
            index[token] = {v: (i, writer_of.get((token, v)))
                            for i, v in enumerate(final)}
        return index

    def _build_graph(self):
        index = self._writer_index()
        edges: Dict[int, Dict[int, str]] = {}
        anomalies: List[str] = []

        def add(a: Optional[int], b: Optional[int], kind: str) -> None:
            if a is None or b is None or a == b:
                return
            # strongest-kind-wins is irrelevant for cycle EXISTENCE; keep
            # the first kind seen, prefer non-rw for classification
            row = edges.setdefault(a, {})
            prev = row.get(b)
            if prev is None or (prev == "rw" and kind != "rw"):
                row[b] = kind

        # ww chains along each key's final order
        for token, final in self.finals.items():
            idx = index[token]
            for i in range(1, len(final)):
                add(idx[final[i - 1]][1], idx[final[i]][1], "ww")

        # wr + rw per observed read
        for op, reads in self.reads.items():
            for token, prefix in reads.items():
                final = self.finals.get(token)
                if final is None:
                    continue
                n = len(prefix)
                if n > len(final) or tuple(final[:n]) != tuple(prefix):
                    anomalies.append(
                        f"G1a/phantom: op {op} read {prefix!r} of key "
                        f"{token}, not a prefix of the final {final!r}")
                    continue
                idx = index[token]
                if n > 0:
                    add(idx[final[n - 1]][1], op, "wr")
                if n < len(final):
                    add(op, idx[final[n]][1], "rw")
        return edges, anomalies

    def _find_cycle(self, edges) -> Optional[List[Tuple[int, int, str]]]:
        """Iterative DFS cycle search; returns the witness edge list."""
        WHITE, GREY, BLACK = 0, 1, 2
        color: Dict[int, int] = {}
        parent: Dict[int, Tuple[int, str]] = {}
        for root in edges:
            if color.get(root, WHITE) is not WHITE:
                continue
            stack = [(root, iter(edges.get(root, ())))]
            color[root] = GREY
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    c = color.get(nxt, WHITE)
                    if c is GREY:
                        # unwind the witness
                        cycle = [(node, nxt, edges[node][nxt])]
                        cur = node
                        while cur != nxt:
                            prev, kind = parent[cur]
                            cycle.append((prev, cur, kind))
                            cur = prev
                        cycle.reverse()
                        return cycle
                    if c is WHITE:
                        color[nxt] = GREY
                        parent[nxt] = (node, edges[node][nxt])
                        stack.append((nxt, iter(edges.get(nxt, ()))))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
        return None

    def verify(self) -> None:
        edges, anomalies = self._build_graph()
        if anomalies:
            raise HistoryViolation("; ".join(anomalies[:5]))
        cycle = self._find_cycle(edges)
        if cycle is not None:
            kinds = [k for (_a, _b, k) in cycle]
            n_rw = sum(1 for k in kinds if k == "rw")
            label = ("G1c" if n_rw == 0
                     else "G-single" if n_rw == 1 else "G2")
            path = " -> ".join(f"{a}-[{k}]->{b}" for a, b, k in cycle)
            raise HistoryViolation(
                f"{label} dependency cycle among txns: {path}")


class CompositeVerifier:
    """Run every checker over the same feed; a history must satisfy each
    (ref: verify/CompositeVerifier.java).  Checker disagreement — one
    accepting what another rejects — surfaces as the rejecting checker's
    violation, failing the run."""

    def __init__(self, *checkers):
        self.checkers = list(checkers)

    def begin(self) -> int:
        ids = [c.begin() for c in self.checkers]
        assert all(i == ids[0] for i in ids), "checker op-id drift"
        return ids[0]

    def on_result(self, op_id, start_micros, end_micros, reads, appends):
        for c in self.checkers:
            c.on_result(op_id, start_micros, end_micros, reads, appends)

    def set_final(self, token, value):
        for c in self.checkers:
            c.set_final(token, value)

    def verify(self) -> None:
        failures = []
        for c in self.checkers:
            try:
                c.verify()
            except HistoryViolation as e:
                failures.append(f"{type(c).__name__}: {e}")
        if failures:
            raise HistoryViolation(" || ".join(failures))
