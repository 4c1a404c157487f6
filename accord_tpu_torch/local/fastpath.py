"""The r18 protocol fast-path escape hatch.

Every hot-loop cache the r18 pass added to the per-op protocol path
(slot-copy command transitions, memoized epoch-range lookups, cached
owned-shard topology views, precomputed message dispatch tables) is
gated on this ONE knob:

    ACCORD_TPU_PROTO_FASTPATH=off   # also: 0 / false / no

Same contract as ``ACCORD_TPU_FUSION=off``: with the knob off, every
fast path falls back to the original straight-line code, and tier-1
must stay green — no optimization may become load-bearing for
correctness.  ``tests/conftest.py`` carries the canary that asserts the
env var actually reaches this function, and
``tools/run_fault_matrix.sh`` runs the net + recovery legs under both
settings, byte-compared.

Hot consumers capture ``_FASTPATH = proto_fastpath_enabled()`` at
module import (an env probe per Command transition would cost more than
the cache saves); the knob is therefore set in the ENVIRONMENT of the
process under test — exactly how the tier-1 sweep and the fault-matrix
legs run it — not flipped mid-process.
"""

import os


def proto_fastpath_enabled() -> bool:
    """True unless ``ACCORD_TPU_PROTO_FASTPATH`` is off/0/false/no."""
    return os.environ.get("ACCORD_TPU_PROTO_FASTPATH", "").lower() \
        not in ("off", "0", "false", "no")


def store_group_enabled() -> bool:
    """True unless ``ACCORD_TPU_STORE_GROUP`` is off/0/false/no.

    The r20 store-grouped execution escape hatch: with the knob on, an
    ``accord_batch`` envelope's protocol sub-bodies decode in one pass
    and all ops targeting the same CommandStore execute under ONE
    scheduled task with ONE SafeCommandStore acquisition (merged
    PreLoadContext, one page-in pass).  With the knob off, every
    envelope unbatches into the per-op path exactly as r16 shipped it.
    Same contract as ``proto_fastpath_enabled``: consumers capture the
    value at module import; ``tests/conftest.py`` carries the canary;
    ``tools/run_fault_matrix.sh`` dual-runs both settings.
    """
    return os.environ.get("ACCORD_TPU_STORE_GROUP", "").lower() \
        not in ("off", "0", "false", "no")
