"""Real serving surface: multi-process TCP cluster over the maelstrom wire.

Everything measured before r12 ran inside the single-threaded discrete-event
sim, which by construction cannot exhibit the regime heavy traffic lives in:
kernel wall-clock and protocol latency coupled in real time, queueing under
overload, retry storms, partial connectivity.  This package is the missing
performance truth-teller — the sim remains THE correctness story (zero
changes to the determinism tiers).

Three layers (ISSUE r12):

- :mod:`accord_tpu.net.framing` / :mod:`accord_tpu.net.codec` —
  length-prefixed frames carrying the exact ``{src, dest, body}`` packets
  the Maelstrom adapter already speaks (``accord_tpu.wire`` payloads
  inside), byte-identical through partial reads and coalesced writes.
  r16: payloads are sniffed per frame between the versioned BINARY codec
  (the serving default: magic + version + a (kind, src, msg_id) prelude
  for pre-decode admission, msgpack body; golden pins in
  ``tests/test_net.py`` freeze the format) and JSON (the debug codec).
- :mod:`accord_tpu.net.transport` / :mod:`accord_tpu.net.server` — an
  asyncio TCP node process: ``MaelstromProcess``'s node wiring behind a
  socket loop instead of stdin/stdout, per-peer reconnect with capped
  exponential backoff + deterministic jitter, sink-owned request timeouts
  (the r07-fixed ``MaelstromSink``), and seedable socket-fault injection
  (``utils.faults`` conn_reset / stalled_peer / slow_link).
- :mod:`accord_tpu.net.admission` — the per-node admission gate in front
  of ``coordinate``: bounded in-flight budget + a latency-aware AIMD
  controller on the sliding p99 of the txn root span, composed with the
  r07 device degradation ladder (quarantine lowers the budget).  Overload
  sheds with a fast, explicit ``Overloaded`` wire error — degrade loudly,
  never die.

:mod:`accord_tpu.net.client` and :mod:`accord_tpu.net.harness` are the
client sink (surfaces ``Overloaded`` for retry-with-backoff) and the
open-loop (Poisson-arrival) load harness ``tools/serve_bench.py`` drives.

r17 adds the elastic-serving control plane: :mod:`accord_tpu.net.reconfig`
(live epoch reconfiguration — operator ``reconfigure`` verb, ``topo_new``
propagation with member addresses, ``epoch_sync`` sync-quorum gossip,
epoch retirement, dynamic peer-link lifecycle, journal-durable epoch
ledger) and :mod:`accord_tpu.net.bootstrap` (chunk-streamed snapshot-fed
bootstrap — ``accord_chunk`` frames through the coalescing links).
"""

from .admission import AdmissionGate, Overloaded
from .framing import FrameDecoder, encode_frame

__all__ = ["AdmissionGate", "Overloaded", "FrameDecoder", "encode_frame"]
