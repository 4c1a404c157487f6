"""Per-node device dispatch scheduler: cross-store launch coalescing.

The port of ``accord_tpu/local/dispatch.py``; under a mesh the fused
flush is ``parallel.sharded.sharded_fused_attr`` (per slice one K5 launch
over the members' slices, the blocks merged on device).  Every CommandStore of a node
would otherwise pay its own launch sequence and round trip per flush and
per drain tick; on a node with many stores that launch tax dominates the
per-element work the kernels already amortize.  The dispatcher lifts the
per-store task-queue batching to the device boundary:

- **Flush coalescing**: deps flushes from all CommandStores of one node
  that become runnable in the same sim event-loop step register with ONE
  dispatcher event.  Stores whose route is a device kernel are priced
  fused-vs-solo from the port's own probe calibration
  (``DeviceState._calibration``: fusing S launches saves S-1 round trips
  and pays the padding waste of unequal tables and the dispatch-time
  snapshots); when fusion wins, ONE store-tagged attributed launch
  (``ops.deps_kernel.fused_flat_attr``: the fused_deps_dense and
  fused_attr_post kernels) answers every member, reading each member's
  table, attribution columns and index where they lie.
- **Deferred harvest**: the fused launch is enqueued without waiting, and
  each member harvests its block in its own store task, enqueued at
  dispatch in store-id order: results land at the next event-loop
  boundary before any dependent task of that store runs, so determinism is
  the scheduler order, never device completion order.  Each member leases
  its device table and attribution columns until its harvest, so an
  escalated re-launch reads them as of dispatch (the in-place scatter
  copies a leased table first).
- **Tick coalescing**: drain ticks registered within one tick window share
  one dispatcher event, and the members' frontier sweeps fuse into one
  launch (``ops.drain_kernel.fused_ready_frontier[_ell]``) when the same
  pricing says it pays.  A store whose drain wavefront is widened runs its
  level pass solo.  On the card the sweep (dense or ELL) writes its
  flags into a pinned host buffer of the tick's own (``_TickSlots``),
  read at the first member's harvest once the launch's event has
  passed.

Correctness contract: every fused launch is bit-identical to the solo
launches it replaces (``tests/test_torch_fused.py``,
``tests/test_torch_dispatch.py``), and the fault ladder composes: an
injected device fault inside a fused launch fails the whole batch over to
the host route deterministically, then quarantines per store exactly as
solo faults do.

Knobs: ``ACCORD_TPU_FUSION=off`` (or 0/false/no) pins solo launches —
fusion must never become load-bearing for correctness; everything else is
priced, not thresholded.
"""

from __future__ import annotations

import os
import time
import weakref
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import devprof
from ..ops import deps_kernel as dk
from ..ops import drain_kernel as drk
from ..utils import faults
from .device_index import _host, _pow2_at_least, _prefix_len, _upload


def fusion_enabled() -> bool:
    """The ACCORD_TPU_FUSION escape hatch: default ON; "off"/"0"/"false"/
    "no" pins every launch solo."""
    return os.environ.get("ACCORD_TPU_FUSION", "").lower() not in (
        "off", "0", "false", "no")


def _profiled_harvest(name, dev0, members, download):
    """Run one fused-result ``download()`` under the device profiler (when
    armed): the harvest-barrier slice, pid-matched to the dispatch slice's
    node row.  Shared by the flush and tick harvest paths."""
    prof = devprof.PROFILER
    _t0 = time.perf_counter() if prof is not None else 0.0
    out = download()
    if prof is not None:
        prof.complete(name, _t0, time.perf_counter(), cat="fused",
                      pid=getattr(getattr(dev0.store, "node", None),
                                  "node_id", 0) or 0,
                      args={"members": members})
    return out


class FusedFlushLaunch:
    """One in-flight fused attributed deps launch: the shared device
    buffers plus the member hints.  The download happens at the FIRST
    member's harvest (faults.check rides it — one transfer crossing per
    fused launch) and is two-stage like the solo path: the stacked scalar
    headers first, then one slice carrying only the live prefix of every
    member's entry block; any device-boundary failure poisons the whole
    batch: every member quarantines and serves its flush from the snapshot
    host scan."""

    def __init__(self, dev_out, hints, s: int, k: int, d_ent: int,
                 b_pad: int, wide: bool):
        self.hdr_dev, self.ent_dev = dev_out
        self.hints = hints
        self.s = s
        self.k = k
        self.d_ent = d_ent        # merged shard blocks per store (mesh)
        self.b_pad = b_pad
        self.wide = wide
        self._out = None
        self.failed: Optional[BaseException] = None

    def materialize(self):
        if self.failed is not None:
            raise self.failed
        if self._out is None:
            n_s = len(self.hints)
            itemsize = 8 if self.wide else 4
            dev0 = self.hints[0]["dev"]
            faults.check("transfer", "fused header download")
            hdr = _profiled_harvest(
                "fused_flush_harvest_header", dev0,
                n_s, lambda: _host(self.hdr_dev))
            hdr = hdr.reshape(n_s, 5 + self.b_pad)
            s_eff = self.d_ent * self.s
            maxtot = min(int(hdr[:, 0].max()), s_eff)
            length = _prefix_len(maxtot, s_eff)
            faults.check("transfer", "fused entry download")
            ent = _profiled_harvest(
                "fused_flush_harvest_entries", dev0,
                n_s, lambda: _host(self.ent_dev[:, :length]))
            # byte accounting lands on the first harvester (deterministic:
            # harvest order is store-id order)
            dev0.download_bytes += hdr.nbytes + ent.nbytes
            dev0.download_bytes_padded += \
                hdr.nbytes + n_s * s_eff * itemsize
            dev0.attr_download_bytes += hdr.nbytes + ent.nbytes
            self._out = (hdr, ent)
        return self._out

    def poison(self, exc: BaseException) -> None:
        if self.failed is None:
            self.failed = exc
            for h in self.hints:
                h["dev"]._device_fault(exc, f"fused collect: {exc}",
                                       sliced=True)
                h["probing"] = False


# free pinned buffers the fused ticks' pool keeps at most
TICK_SLOTS_KEPT = 4


class _TickSlot:
    """A pinned host buffer that one fused tick's kernel writes its
    flags into (a power of two of bytes), and an event recorded on the
    launch's stream right after the launch: the buffer serves another
    tick only once that event has passed."""

    __slots__ = ("buf", "event")

    def __init__(self, nbytes: int) -> None:
        self.buf = torch.empty(_pow2_at_least(nbytes, 4096),
                               dtype=torch.uint8, pin_memory=True)
        self.event = torch.cuda.Event()

    def launch(self, kernel, states):
        """``kernel(states, out=...)`` into this buffer, viewed as
        bool[S, n_max]; the event is recorded after it, raise or not."""
        s, n_max = len(states), max(st.status.shape[0] for st in states)
        try:
            return kernel(states, out=self.buf[:s * n_max].view(torch.bool)
                          .view(s, n_max))
        finally:
            self.event.record(
                torch.cuda.current_stream(states[0].status.device))


class _TickSlots:
    """The pool of _TickSlots, one for each fused tick in flight: two
    ticks with disjoint members may be launched before either is
    harvested (a member's tick task runs later, through its store's
    queue), so no two share a buffer.  A slot comes back at its tick's
    first harvest, at its poison, at a failed launch, or when the tick is
    dropped unharvested (``FusedTick``); it is taken again, or dropped
    past ``TICK_SLOTS_KEPT`` free slots, only once its event has passed.
    One pool for the process: a buffer leaves it only behind its event."""

    def __init__(self) -> None:
        self.free: List[_TickSlot] = []

    def take(self, states) -> _TickSlot:
        nbytes = len(states) * max(st.status.shape[0] for st in states)
        for k, slot in enumerate(self.free):
            if slot.buf.numel() >= nbytes and slot.event.query():
                return self.free.pop(k)
        return _TickSlot(nbytes)

    def give(self, slot: Optional[_TickSlot]) -> None:
        if slot is None:
            return
        self.free.append(slot)
        if len(self.free) > TICK_SLOTS_KEPT:
            done = [f for f in self.free if f.event.query()]
            if done:
                self.free.remove(min(done, key=lambda f: f.buf.numel()))


_TICK_SLOTS = _TickSlots()


class FusedTick:
    """One in-flight fused drain-frontier launch (see FusedFlushLaunch for
    the failure contract).  ``slot``: the _TickSlot whose pinned buffer
    the launch writes its flags into (``dev_out`` views it); the first
    harvest waits for that launch's event and copies the flags out.
    The slot goes back to the pool at that harvest, at ``poison``, or
    when the tick is dropped unharvested (its members' tick tasks ended
    before ``result_for``), always behind its launch's event."""

    def __init__(self, dev_out, group, slot: Optional[_TickSlot] = None):
        self.dev = dev_out
        self.slot = slot
        self._release = (None if slot is None
                         else weakref.finalize(self, _TICK_SLOTS.give, slot))
        self.rows = {id(dev): (i, live, dev.drain.version)
                     for i, (dev, _st, live) in enumerate(group)}
        self.members = [dev for dev, _st, _lv in group]
        self._out = None
        self.failed: Optional[BaseException] = None

    def serves(self, dev) -> bool:
        return id(dev) in self.rows

    def version_for(self, dev) -> int:
        return self.rows[id(dev)][2]

    def _download(self) -> np.ndarray:
        if self.slot is None:
            return _host(self.dev)
        self.slot.event.synchronize()      # the launch has written them
        flags = self.dev.numpy().copy()
        self._release()
        return flags

    def result_for(self, dev) -> np.ndarray:
        if self.failed is not None:
            raise self.failed
        if self._out is None:
            faults.check("transfer", "fused drain download")
            self._out = _profiled_harvest(
                "fused_tick_harvest", self.members[0],
                len(self.members), self._download)
        i, live, _v = self.rows[id(dev)]
        ready = self._out[i][: len(live)]
        return live[ready & dev.drain.active[live]]

    def poison(self, exc: BaseException) -> None:
        if self.failed is None:
            self.failed = exc
            if self._release is not None:
                self._release()
            for dev in self.members:
                dev._device_fault(exc, f"fused drain collect: {exc}")


class DeviceDispatcher:
    """The per-node scheduler coalescing device launches across the node's
    CommandStores (module docstring)."""

    def __init__(self, node):
        self.node = node
        self.fusion = fusion_enabled()
        self._flush_pending: List = []
        self._flush_scheduled = False
        self._tick_pending: List = []
        self._tick_scheduled = False
        # launch accounting (the sim stats read these): fused launches
        # serve many member flushes/ticks each
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

    def _handled(self, exc: BaseException) -> None:
        agent = getattr(self.node, "agent", None)
        if agent is not None and hasattr(agent, "on_handled_exception"):
            agent.on_handled_exception(exc)

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
        hints: Dict[int, dict] = {}
        launch = None
        if self.fusion and len(plans) >= 2:
            try:
                for dev, batch in plans:
                    h = dev.fused_eligible([q for q, _b, _d in batch])
                    if h is not None:
                        h["batch"] = batch
                        hints[id(dev)] = h
                if len(hints) >= 2 and \
                        self._fused_flush_pays(list(hints.values())):
                    launch = self._launch_fused_flush(list(hints.values()))
                else:
                    hints = {}
            except BaseException as e:  # noqa: BLE001
                # not a device fault (those are absorbed inside
                # _launch_fused_flush as the whole-batch host failover): an
                # unexpected host-side error must never strand the claimed
                # batches with their done callbacks unfired — serve them
                # solo, which carries its own failure delivery
                self._handled(e)
                for h in hints.values():
                    h["dev"]._release_fused_lease(h)
                hints = {}
                launch = None
        # harvest order IS the deterministic scheduler order: one store
        # task per member, enqueued here in ascending store id
        for dev, batch in plans:
            h = hints.get(id(dev))
            if h is not None:
                dev.store.execute(
                    PreLoadContext.empty(),
                    partial(dev.fused_harvest, hint=h, launch=launch))
            else:
                self.n_solo_flushes += 1
                dev.store.execute(PreLoadContext.empty(),
                                  partial(dev._flush_batch, batch=batch))

    def _fused_flush_pays(self, hints) -> bool:
        """Price ONE fused launch against the members' solo launches with
        the port's probe calibration: fusing saves (S-1) round trips and
        pays the padding waste of stacking unequal tables / batches."""
        dev0 = hints[0]["dev"]
        calib = dev0._calibration()
        rtt, c_dev = calib["rtt"], calib["c_dev"]
        d = 1
        if dev0.mesh is not None:
            d = dev0.mesh.size
            rtt = calib.get("rtt_mesh", rtt)
        solo = sum(2.0 * rtt + c_dev * h["solo_elems"] for h in hints)
        b_pad = _pow2_at_least(max(h["b_pad"] for h in hints), 1)
        q_m = max(h["q_m"] for h in hints)
        n_max = max(h["cap"] for h in hints)
        m_max = max(h["m_iv"] for h in hints)
        fused_elems = len(hints) * b_pad * (n_max // d) * q_m * m_max
        # the deferred harvest needs dispatch-time mirror snapshots the
        # solo immediate path never takes — charge the stale members'
        # copies at the measured memcpy rate (version-cached, so an
        # unmutated mirror re-fuses for free)
        c_copy = calib.get("c_copy", calib["c_host"] / 20.0)
        snap_cost = c_copy * sum(h["snap_elems"] for h in hints)
        return 2.0 * rtt + c_dev * fused_elems + snap_cost < solo

    def _launch_fused_flush(self, hints) -> Optional[FusedFlushLaunch]:
        prof = devprof.PROFILER
        _t0 = time.perf_counter() if prof is not None else 0.0
        devs = [h["dev"] for h in hints]
        mesh = devs[0].mesh            # one node -> one mesh for all stores
        d = 1 if mesh is None else mesh.size
        q_m = max(h["q_m"] for h in hints)
        b_pad = _pow2_at_least(max(h["b_pad"] for h in hints), 1)
        s = max(min(dev._batch_flat, b_pad * (h["cap"] // d)
                    * h["m_iv"] * q_m)
                for dev, h in zip(devs, hints))
        k = max(min(dev._batch_k, (h["cap"] // d) * h["m_iv"] * q_m)
                for dev, h in zip(devs, hints))
        qmats = np.empty((len(hints), b_pad, 7 + 2 * q_m), np.int64)
        pm = np.zeros(len(hints), np.int64)
        pl = np.zeros(len(hints), np.int64)
        pn = np.zeros(len(hints), np.int32)
        m_max = max(h["m_iv"] for h in hints)
        # the fused scan pads every table to the group's interval width,
        # so codes scale on m_max; the entry dtype must hold the widest
        # member's codes — under a mesh the merged entries carry GLOBAL
        # slot ids on the padded slice stride, so the crossover is the
        # whole padded slot space
        rankbs = np.zeros((len(hints), b_pad), np.int64)
        pad_shard_n = max(h["cap"] // d for h in hints)
        if mesh is not None:
            wide = dk.wide_codes(d * pad_shard_n, m_max, q_m)
        else:
            wide = any(dk.wide_codes(h["cap"], m_max, q_m) for h in hints)
        for i, h in enumerate(hints):
            qnp, qmi, nq = h["qnp"], h["q_m"], h["nq"]
            rows_p = np.minimum(np.arange(b_pad), nq - 1)
            qmats[i, :, :7] = qnp[rows_p, :7]
            qmats[i, :, 7:7 + q_m] = dk.PAD_LO
            qmats[i, :, 7 + q_m:] = dk.PAD_HI
            qmats[i, :, 7:7 + qmi] = qnp[rows_p, 7:7 + qmi]
            qmats[i, :, 7 + q_m:7 + q_m + qmi] = qnp[rows_p, 7 + qmi:]
            rankbs[i] = h["rankb_np"][rows_p]
            if h["prune"] is not None:
                pm[i], pl[i], pn[i] = h["prune"]
            h["gmap"] = np.where(np.arange(b_pad) < nq,
                                 np.arange(b_pad), -1)
            h["row"] = i
            h["d_mesh"] = d
            h["shard_n"] = h["cap"] // d
            h["pad_shard_n"] = pad_shard_n if mesh is not None else None
            h["b_pad_c"] = b_pad
            h["q_m_c"] = q_m
            h["mq"] = m_max * q_m
            h["wide"] = wide
            h["qmat_np"] = qmats[i]
            h["rankb_pad"] = rankbs[i]
        # commit first (probe bookkeeping, mirror snapshots, route
        # observation): a launch fault below must still find the
        # dispatch-time snapshot to serve the host failover from
        for h in hints:
            h["dev"].fused_commit(h)
        try:
            dk.launch_check("fused")
            for h in hints:
                dev = h["dev"]
                h["table"] = dev.fused_table()
                if mesh is None:
                    h["attr"] = dev.deps.device_attr_cols()
                    held = (h["table"], h["attr"])
                else:
                    from ..parallel.sharded import slice_of
                    h["attr"] = dev.deps.device_attr_cols_sharded(mesh)
                    held = tuple(slice_of(c, i) for c in (h["table"],
                                                          h["attr"])
                                 for i in range(d))
                # held until this member's harvest: a re-launch reads the
                # table and columns as of dispatch (copy on write)
                h["lease"] = dev.deps.share_device(held)
            # static leg switches, OR'd over the group: a member with a
            # trivial floor map / empty elision index just computes
            # nothing in the shared legs
            fl_ = any(not h.get("floor_skip", False) for h in hints)
            el_ = any(h["aidx"].u > 0 for h in hints)
            if mesh is not None:
                from ..parallel.sharded import sharded_fused_attr
                out = sharded_fused_attr(mesh, len(hints), q_m, s, k,
                                         wide, fl_, el_)(
                    *[h["table"] for h in hints],
                    *[h["attr"] for h in hints],
                    *[h["aidx"].device_replicated(mesh) for h in hints],
                    _upload(qmats, mesh.dev0), _upload(rankbs, mesh.dev0),
                    pm, pl, pn)
            else:
                device = devs[0].device
                out = dk.fused_flat_attr(
                    [h["table"] for h in hints], [h["attr"] for h in hints],
                    [h["aidx"].device(device) for h in hints],
                    _upload(qmats, device), _upload(rankbs, device),
                    (pm, pl, pn), q_m, s, k, wide, fl_, el_)
        except faults.DEVICE_EXCEPTIONS as e:
            # a device fault inside the fused launch fails the WHOLE batch
            # over to the host route, then quarantines per store as solo
            # faults do
            for h in hints:
                h["dev"].fused_fail_to_host(h, e)
            return None
        self.n_fused_launches += 1
        self.n_fused_members += len(hints)
        if prof is not None:
            # pack + upload + enqueue of ONE store-tagged launch in place
            # of len(hints) solo launches (harvest lands in
            # fused_flush_harvest)
            prof.complete("fused_flush_dispatch", _t0, time.perf_counter(),
                          cat="fused", pid=getattr(self.node, "node_id", 0),
                          args={"members": len(hints),
                                "nq": sum(h["nq"] for h in hints)})
        if self.on_fused is not None:
            self.on_fused("flush", len(hints),
                          sum(h["nq"] for h in hints))
        return FusedFlushLaunch(out, hints, s, k, d, b_pad, wide)

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
        fused_by: Dict[int, FusedTick] = {}
        if self.fusion and len(devs) >= 2:
            try:
                fused_by = self._prepare_fused_ticks(devs)
            except BaseException as e:  # noqa: BLE001
                # an unexpected host-side error preparing the fused sweep
                # must never leave the members' _tick_scheduled flags stuck
                # True (a node-wide lost wakeup): every member still gets
                # its solo tick task below
                self._handled(e)
                fused_by = {}
        for dev in devs:
            f = fused_by.get(id(dev))
            if f is None:
                self.n_solo_ticks += 1
            dev.store.execute(PreLoadContext.empty(),
                              partial(dev._tick, fused=f))

    def _prepare_fused_ticks(self, devs) -> Dict[int, FusedTick]:
        # a widened-wavefront store (_drain_wavefront > 1) is mid-cascade
        # and runs the level pass solo — the fused frontier sweep would
        # shrink its candidate set back to one antichain
        cands = [d for d in devs
                 if not (d.host_pinned or d._dev_quar_flushes > 0)
                 and d._drain_wavefront <= 1
                 and d.drain.active.any()]
        if len(cands) < 2:
            return {}
        try:
            dk.launch_check("fused drain")
            built = [(d,) + d.drain.state() for d in cands]
        except faults.DEVICE_EXCEPTIONS as e:
            # whole-batch failover: every candidate quarantines; their
            # tick tasks sweep on host via the quarantine guard
            for d in cands:
                d._device_fault(e, f"fused drain tick: {e}")
            return {}
        dense, ell = [], []
        for dev, state, live in built:
            if isinstance(state, drk.EllDrainState):
                ell.append((dev, state, live))
            else:
                n = state.status.shape[0]
                if dev.mesh is not None and n % dev.mesh.size == 0 \
                        and dev._mesh_tick_pays(n):
                    continue       # the solo mesh sweep is the modeled winner
                dense.append((dev, state, live))
        out: Dict[int, FusedTick] = {}
        calib = devs[0]._calibration()
        for group, kernel, kind in (
                (dense, drk.fused_ready_frontier, "dense"),
                (ell, drk.fused_ready_frontier_ell, "ell")):
            if len(group) < 2 or not self._fused_tick_pays(group, calib,
                                                           kind):
                continue
            prof = devprof.PROFILER
            _t0 = time.perf_counter() if prof is not None else 0.0
            states = [st for _d, st, _lv in group]
            slot = None
            try:
                if states[0].status.is_cuda:
                    # the flags go over the bus into a pinned buffer of
                    # this tick's own
                    slot = _TICK_SLOTS.take(states)
                    out_dev = slot.launch(kernel, states)
                else:
                    out_dev = kernel(states)
            except faults.DEVICE_EXCEPTIONS as e:
                _TICK_SLOTS.give(slot)
                for dev, _st, _lv in group:
                    dev._device_fault(e, f"fused drain launch: {e}")
                continue
            except BaseException:
                _TICK_SLOTS.give(slot)
                raise
            ft = FusedTick(out_dev, group, slot)
            self.n_fused_tick_launches += 1
            self.n_fused_tick_members += len(group)
            if prof is not None:
                prof.complete("fused_tick_dispatch", _t0,
                              time.perf_counter(), cat="fused",
                              pid=getattr(self.node, "node_id", 0),
                              args={"members": len(group), "kind": kind})
            if self.on_fused is not None:
                self.on_fused("tick", len(group), 0)
            for dev, _st, _lv in group:
                out[id(dev)] = ft
        return out

    def _fused_tick_pays(self, group, calib, kind: str) -> bool:
        """One fused sweep saves (S-1) launches and round trips and pays
        for the pad rows / edges of unequal members."""
        rtt, c_dev = calib["rtt"], calib["c_dev"]
        if kind == "dense":
            sizes = [st.status.shape[0] for _d, st, _lv in group]
            n_max = max(sizes)
            waste = c_dev * (len(sizes) * n_max * n_max
                             - sum(n * n for n in sizes))
        else:
            shapes = [st.adj_idx.shape for _d, st, _lv in group]
            n_max = max(sh[0] for sh in shapes)
            d_max = max(sh[1] for sh in shapes)
            waste = c_dev * (len(shapes) * n_max * d_max
                             - sum(n * dd for n, dd in shapes))
        return 2.0 * rtt * (len(group) - 1) > waste
