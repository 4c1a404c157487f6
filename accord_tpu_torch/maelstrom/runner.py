"""In-process Maelstrom simulation: real MaelstromProcess nodes exchanging
JSON-serialised packets over a seeded random-delay queue, driven by a
generated list-append client workload and checked for strict
serializability.

Rebuild of ref: accord-maelstrom/src/test/java/accord/maelstrom/Runner.java
:40-190 + Cluster.java:70-330 — the same node logic that speaks to the real
Maelstrom harness, exercised deterministically in one process.  Packets are
serialised to JSON strings and parsed on delivery, so the full wire codec is
on the hot path (serde divergence fails the run, not just a unit test).
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional

from ..sim.cluster import PendingQueue, SimScheduler
from ..sim.verifier import StrictSerializabilityVerifier
from ..utils.random_source import RandomSource
from .node import MaelstromProcess, token_of


class RunResult:
    def __init__(self):
        self.ops_ok = 0
        self.ops_failed = 0
        self.ops_unresolved = 0
        self.packets = 0
        # per-op commit latency in SIMULATED micros (client submit ->
        # txn_ok) — the configs[0]/[1] p99 metric
        self.latencies_micros: List[int] = []
        # the run's obs.Observability (set by the runner that produced
        # this result) — obs_row_fields reads phase latencies from it
        self.obs = None

    def p99_micros(self) -> Optional[int]:
        if not self.latencies_micros:
            return None
        xs = sorted(self.latencies_micros)
        return xs[min(len(xs) - 1, int(len(xs) * 0.99))]

    def obs_row_fields(self) -> dict:
        """Per-phase p50/p99 (sim ms) + fast-path rate from the run's
        observability bundle — the r09 bench config-row fields.  Empty
        under ACCORD_TPU_OBS=off (the row shape degrades, never errors)."""
        obs = self.obs
        if obs is None or obs.spans is None:
            return {}
        phases = {}
        for phase, row in obs.metrics.phase_percentiles().items():
            phases[phase] = {"p50_ms": round(row["p50"] / 1000, 2),
                             "p99_ms": round(row["p99"] / 1000, 2),
                             "n": row["n"]}
        out = {"phases_ms": phases}
        rate = obs.spans.fast_path_rate()
        if rate is not None:
            out["fast_path_rate"] = round(rate, 4)
        return out

    def __repr__(self):
        return (f"RunResult(ok={self.ops_ok}, failed={self.ops_failed}, "
                f"unresolved={self.ops_unresolved}, packets={self.packets})")


class MaelstromRunner:
    """(ref: maelstrom test Runner/Cluster)."""

    def __init__(self, n_nodes: int = 3, seed: int = 0, shards: int = 8,
                 mean_latency_micros: int = 1_000,
                 device_mode: Optional[bool] = None,
                 durability: bool = False):
        # durability defaults OFF in the runner: background rounds keep the
        # simulated queue busy through every time-bounded drain; the
        # durability subsystem has its own deterministic-tick tests
        self.queue = PendingQueue()
        self.rs = RandomSource(seed)
        self.net = self.rs.fork()
        self.names = [f"n{i}" for i in range(1, n_nodes + 1)]
        self.processes: Dict[str, MaelstromProcess] = {}
        self.result = RunResult()
        self.mean_latency = mean_latency_micros
        scheduler = SimScheduler(self.queue)
        # one shared observability bundle (obs.*): every process node's
        # coordinate FSM stamps phase spans in this runner's SIM time, so
        # the bench config rows can report per-phase p50/p99 latency and
        # the fast-path rate (spans None under ACCORD_TPU_OBS=off)
        from ..obs import Observability
        self.obs = Observability(now=lambda: self.queue.now)
        self.result.obs = self.obs
        # client replies (dest "c...") land here
        self.client_handlers: Dict[int, Callable[[dict], None]] = {}
        for name in self.names:
            proc = MaelstromProcess(
                emit=self._make_emit(name), scheduler=scheduler,
                now_micros=lambda: self.queue.now,
                shards=shards, device_mode=device_mode,
                durability=durability, obs=self.obs)
            self.processes[name] = proc
        # init handshake (ref: Runner sends init to every node first)
        for i, name in enumerate(self.names):
            self._deliver(name, {"src": "c0", "dest": name,
                                 "body": {"type": "init", "msg_id": i + 1,
                                          "node_id": name,
                                          "node_ids": list(self.names)}})
        self.queue_drain()

    # -- network ------------------------------------------------------------
    def _make_emit(self, src: str) -> Callable[[str, dict], None]:
        def emit(dest, body: dict) -> None:
            packet = {"src": src, "dest": dest, "body": body}
            line = json.dumps(packet)      # full serde on the hot path
            self.result.packets += 1
            if isinstance(dest, str) and dest.startswith("c"):
                handler = self.client_handlers.get(body.get("in_reply_to"))
                if handler is not None:
                    self.queue.add(self.queue.now,
                                   lambda: handler(json.loads(line)["body"]))
                return
            delay = self.mean_latency // 2 + self.net.next_int(self.mean_latency + 1)
            self.queue.add(self.queue.now + delay,
                           lambda: self._deliver(dest, json.loads(line)))
        return emit

    def _deliver(self, dest: str, packet: dict) -> None:
        proc = self.processes.get(dest)
        if proc is not None:
            proc.handle(packet)

    def queue_drain(self, max_micros: int = 60_000_000) -> None:
        """Run until the queue empties or the simulated-time budget is spent
        (recurring tasks — sweeper, progress-log scans — never exhaust, so
        the bound is time, as in sim.cluster.run_until_quiescent)."""
        deadline = self.queue.now + max_micros
        while self.queue.now <= deadline:
            fn = self.queue.pop()
            if fn is None:
                return
            fn()

    # -- workload (ref: Runner.java:123-190 generated txn bodies) -----------
    def run_workload(self, n_ops: int = 50, n_keys: int = 10,
                     verify: bool = True,
                     keys_per_txn: Optional[int] = None,
                     zipf_skew: Optional[float] = None,
                     spread_ring: bool = False,
                     value_kinds: Optional[tuple] = None) -> RunResult:
        """``keys_per_txn`` pins the txn width (default 1..3 random);
        ``zipf_skew`` draws keys Zipf-distributed over [0, n_keys) —
        configs[1]'s 4-key multi-partition Zipf-0.9 shape.
        ``spread_ring`` strides key values across the whole token ring so
        an N-key space actually lands on every shard (small ints all hash
        into shard 0 otherwise — a 'multi-partition' workload must be).
        ``value_kinds`` cycles appended values through the reference's
        datum kinds (subset of ("long", "string", "double", "hash");
        default None keeps plain unique ints) — values cross the client
        JSON boundary in wire form ({"hash": n} for HASH) and the verifier
        compares their canonical decoded forms."""
        from ..primitives.datum import datum_from_json
        wl = self.rs.fork()
        verifier = StrictSerializabilityVerifier()
        next_val = [0]
        pending = {}
        stride = ((1 << 32) // n_keys) if spread_ring else 1

        def pick_key() -> int:
            k = (wl.next_zipf(n_keys, zipf_skew) if zipf_skew is not None
                 else wl.next_int(n_keys))
            return k * stride

        def make_value(i: int):
            """(client-JSON form, canonical form) for unique value #i —
            mixed datum kinds keep global uniqueness because ``i`` is
            unique and the kind is a function of i."""
            if not value_kinds:
                return i, i
            kind = value_kinds[i % len(value_kinds)]
            if kind == "long":
                vj = (1 << 33) + i       # past int32: a real 64-bit long
            elif kind == "string":
                vj = f"s{i}"
            elif kind == "double":
                vj = i + 0.5
            elif kind == "hash":
                vj = {"hash": i}
            else:
                raise ValueError(f"unknown datum kind {kind!r}")
            return vj, datum_from_json(vj)

        def submit(i: int):
            node = self.names[wl.next_int(len(self.names))]
            n = keys_per_txn if keys_per_txn is not None \
                else wl.next_int(3) + 1
            n = min(n, n_keys)
            chosen = set()
            # redraw until n DISTINCT keys: under zipf the hot key repeats,
            # and silently shrinking the txn would mislabel the metric
            guard = 0
            while len(chosen) < n and guard < 64:
                chosen.add(pick_key())
                guard += 1
            keys = sorted(chosen)
            ops = []
            writes = {}
            reads = []
            for k in keys:
                if wl.decide(0.6):
                    next_val[0] += 1
                    vj, v = make_value(next_val[0])
                    ops.append(["append", k, vj])
                    writes[token_of(k)] = writes.get(token_of(k), ()) + (v,)
                else:
                    ops.append(["r", k, None])
                    reads.append(token_of(k))
            op_id = verifier.begin()
            start = self.queue.now
            pending[i] = True
            msg_id = 10_000 + i

            def on_reply(body: dict):
                pending.pop(i, None)
                if body.get("type") != "txn_ok":
                    self.result.ops_failed += 1
                    return
                self.result.ops_ok += 1
                self.result.latencies_micros.append(self.queue.now - start)
                observed = {}
                for op in body["txn"]:
                    if op[0] == "r":
                        t = token_of(op[1])
                        # canonical datum forms: the store and the writes
                        # census hold decoded values ({"hash": n} -> DatumHash)
                        vals = tuple(datum_from_json(v) for v in op[2])
                        # strip intra-txn own-appends suffix: the verifier
                        # models reads as pre-state
                        own = writes.get(t, ())
                        if own and vals[-len(own):] == own:
                            vals = vals[: len(vals) - len(own)]
                        observed[t] = vals
                verifier.on_result(op_id, start, self.queue.now,
                                   observed, writes)

            self.client_handlers[msg_id] = on_reply
            self._deliver(node, {"src": f"c{i + 1}", "dest": node,
                                 "body": {"type": "txn", "msg_id": msg_id,
                                          "txn": ops}})

        for i in range(n_ops):
            submit(i)
            if wl.decide(0.3):
                self.queue_drain()
        self.queue_drain()
        self.result.ops_unresolved = len(pending)
        if verify:
            # finals: after quiescence every owning replica has the full
            # list; take the longest copy per token across data stores
            finals = {}
            for proc in self.processes.values():
                store = proc.node.data_store
                for token in store.tokens():
                    value = store.get(token)
                    if len(value) > len(finals.get(token, ())):
                        finals[token] = value
            for token, value in finals.items():
                verifier.set_final(token, value)
            verifier.verify()
            for proc in self.processes.values():
                if proc.failures:
                    raise proc.failures[0]
        return self.result
