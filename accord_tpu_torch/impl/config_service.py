"""Epoch-history bookkeeping base for ConfigurationService integrations.

Rebuild of ref: accord-core/src/main/java/accord/impl/
AbstractConfigurationService.java:368 — the common ledger an integration
builds on: contiguous epoch history, listener registry with replayed
notifications, and fetch/report seams the concrete service fills in
(the simulator asks its Cluster; a production service asks its metadata
store; the Maelstrom adapter is a single static epoch).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import api
from ..topology.topology import Topology
from ..utils import invariants


class AbstractConfigurationService(api.ConfigurationService):
    """(ref: impl/AbstractConfigurationService.java)."""

    def __init__(self):
        self._epochs: List[Topology] = []     # contiguous, ascending
        self._listeners: List = []

    # -- the seams a concrete service fills in ------------------------------
    def fetch_topology_for_epoch(self, epoch: int) -> None:
        """Ask the outside world for an epoch's topology; deliver it back
        through report_topology."""

    def acknowledge_epoch(self, epoch_ready, start_sync: bool = True) -> None:
        """Gossip this node's sync-complete for the epoch."""

    # -- history ------------------------------------------------------------
    def report_topology(self, topology: Topology) -> None:
        """Ingest a (possibly already-known) epoch and notify listeners
        (ref: reportTopology's contiguity bookkeeping)."""
        if self._epochs:
            last = self._epochs[-1].epoch
            if topology.epoch <= last:
                return
            invariants.check_argument(
                topology.epoch == last + 1,
                "non-contiguous epoch %d reported (have %d)",
                topology.epoch, last)
        self._epochs.append(topology)
        for listener in list(self._listeners):
            self._notify(listener, topology)

    @staticmethod
    def _notify(listener, topology: Topology) -> None:
        """Listeners per the SPI are ConfigurationServiceListener objects
        (on_topology_update(topology, started_sync)); single-argument
        implementations (Node/TopologyManager's own on_topology_update) and
        bare callables are accepted too."""
        import inspect
        fn = getattr(listener, "on_topology_update", None)
        if fn is None:
            listener(topology)
            return
        try:
            n_params = len(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            n_params = 2
        if n_params <= 1:
            fn(topology)
        else:
            fn(topology, True)

    def register_listener(self, listener) -> None:
        self._listeners.append(listener)
        for t in self._epochs:   # replay known history to late registrants
            self._notify(listener, t)

    def current_topology(self) -> Topology:
        invariants.check_state(bool(self._epochs), "no topology known")
        return self._epochs[-1]

    def get_topology_for_epoch(self, epoch: int) -> Optional[Topology]:
        if not self._epochs:
            return None
        first = self._epochs[0].epoch
        i = epoch - first
        return self._epochs[i] if 0 <= i < len(self._epochs) else None
