"""Per-node device dispatch scheduler.

The port of ``accord_tpu/local/dispatch.py`` without its fused launches:
deps flushes from all CommandStores of one node that become runnable in the
same sim event-loop step register with ONE dispatcher event, and drain
ticks registered within one tick window share one dispatcher event — so
the batching boundaries, and with them the burn's history, are the
reference's.  Every flush and tick is then served solo, in ascending store
id order, exactly as the reference serves them under
``ACCORD_TPU_FUSION=off``.  Fused multi-store launches are a later slice;
their counters exist and stay 0.
"""

from __future__ import annotations

from functools import partial
from typing import List


class DeviceDispatcher:
    """The per-node scheduler of the node's CommandStores' device work."""

    def __init__(self, node):
        self.node = node
        self.fusion = False
        self._flush_pending: List = []
        self._flush_scheduled = False
        self._tick_pending: List = []
        self._tick_scheduled = False
        # launch accounting (the sim stats read these); fused launches are
        # not in this slice
        self.n_fused_launches = 0
        self.n_fused_members = 0
        self.n_solo_flushes = 0
        self.n_fused_tick_launches = 0
        self.n_fused_tick_members = 0
        self.n_solo_ticks = 0
        # events -> member flushes -> queries: the device-side occupancy
        self.n_flush_events = 0
        self.n_flush_members = 0
        self.n_flush_queries = 0
        # observer(kind, n_members, nq) — the sim cluster wires stats/trace
        self.on_fused = None

    # -- flush side ---------------------------------------------------------
    def register_flush(self, dev) -> None:
        self._flush_pending.append(dev)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            # one scheduler hop (zero sim-time) so every same-instant
            # message's store task enqueues its queries BEFORE dispatch
            self.node.scheduler.now(self._run_flushes)

    def _run_flushes(self) -> None:
        from .command_store import PreLoadContext
        self._flush_scheduled = False
        devs = self._flush_pending
        self._flush_pending = []
        if not getattr(self.node, "alive", True):
            return    # dead incarnation (restart): ghost work must not run
        devs.sort(key=lambda d: d.store.store_id)
        plans = []
        for dev in devs:
            batch = dev._q_pending
            dev._q_pending = []
            if batch:
                plans.append((dev, batch))
        if plans:
            self.n_flush_events += 1
            self.n_flush_members += len(plans)
            self.n_flush_queries += sum(len(b) for _d, b in plans)
        # one store task per member, enqueued in ascending store id
        for dev, batch in plans:
            self.n_solo_flushes += 1
            dev.store.execute(PreLoadContext.empty(),
                              partial(dev._flush_batch, batch=batch))

    # -- tick side ----------------------------------------------------------
    def register_tick(self, dev) -> None:
        self._tick_pending.append(dev)
        if not self._tick_scheduled:
            self._tick_scheduled = True
            self.node.scheduler.once(dev.TICK_DELAY_MICROS, self._run_ticks)

    def _run_ticks(self) -> None:
        from .command_store import PreLoadContext
        self._tick_scheduled = False
        devs = self._tick_pending
        self._tick_pending = []
        if not getattr(self.node, "alive", True):
            return    # dead incarnation (restart): ghost work must not run
        devs.sort(key=lambda d: d.store.store_id)
        for dev in devs:
            self.n_solo_ticks += 1
            dev.store.execute(PreLoadContext.empty(), dev._tick)
