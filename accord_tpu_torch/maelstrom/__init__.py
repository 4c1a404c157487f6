"""Maelstrom (Jepsen) adapter: a real stdin/stdout JSON node plus an
in-process Runner for deterministic tests.

Rebuild of ref: accord-maelstrom/ — Main.java (node), Json.java (serde; ours
is accord_tpu.wire), MaelstromRequest/Reply (the "txn" list-append
workload), test Runner.java/Cluster.java (in-process sim).
"""

from .node import (MaelstromProcess, build_maelstrom_topology,
                   node_name_to_id, token_of)
from .runner import MaelstromRunner, RunResult

__all__ = ["MaelstromProcess", "MaelstromRunner", "RunResult",
           "build_maelstrom_topology", "node_name_to_id", "token_of"]
