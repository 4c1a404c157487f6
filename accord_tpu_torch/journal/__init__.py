"""Durable storage beneath the message-sourced journal (ISSUE r13).

Layers (each its own module, composable and separately testable):

- ``segment``  — length+CRC32-framed records in fixed-size files;
  torn-tail truncation on open; seedable disk faults at every I/O.
- ``wal``      — the segmented append-only log: monotonic sequence,
  rolling, recycling of fully-snapshotted segments.
- ``commit``   — group commit: one fsync acknowledges the batch, the
  batching window priced off a once-per-process fsync micro-probe.
- ``snapshot`` — whole-state snapshots that bound replay and set the
  segment-recycling floor.
- ``durable``  — :class:`DurableJournal`, the drop-in ``Journal``
  subclass the serving node hands to ``Node(journal=...)``, plus
  :class:`JournaledKVDataStore`.
- ``recover``  — crash-recovery replay and the ``open_journal`` entry
  point.
- ``selftest`` — the seeded disk-fault/crash-point harness the fault
  matrix runs (``ACCORD_TPU_FAULT_MATRIX=disk``).
"""

from .durable import DurableJournal, JournaledKVDataStore  # noqa: F401
from .recover import open_journal                          # noqa: F401
from .wal import WriteAheadLog                             # noqa: F401
