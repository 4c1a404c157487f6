"""The port's DeviceDispatcher and drain tick in the reference's default
configuration, on the CPU (plain versions of the kernels).

(a) bench config 5's harness, cut to 4 stores x 64 txns with 4-query
flushes on one dispatcher: fused launches (pricing forced to pay) build
the same per-store Deps as solo launches; (b) ``ACCORD_TPU_FUSION=off``
pins solo launches; (c) a 6-deep chain through ``_tick`` with a widened
wavefront runs the level pass and proposes the reference's candidates;
(d) ``ACCORD_TPU_DRAIN=fixpoint`` keeps the wavefront at 1, while the
default doubles it; (e) a fused member's escalated re-launch reads its
table as of dispatch, though rows were scattered into it in between."""

import numpy as np
import pytest

import chip_smoke as cs

STORES, NPER, KEYS = 4, 48, 64


@pytest.fixture(autouse=True)
def _port_primitives(monkeypatch):
    monkeypatch.setenv("ACCORD_TPU_STORE_SHARD", "off")
    cs.P.load()


def _force_pays(monkeypatch):
    monkeypatch.setattr(cs.P.DeviceDispatcher, "_fused_flush_pays",
                        lambda self, hints: True)


def _run(fusion, rounds=3):
    node, devs = cs.launch_harness(STORES, NPER, KEYS, fusion, "cpu")
    built = cs.drive_flushes(node, devs, rounds, KEYS, seed=7)
    return node.dispatcher, devs, [cs.deps_digest(b) for b in built]


def test_fused_flushes_build_solo_deps(monkeypatch):
    _force_pays(monkeypatch)
    solo, _d, want = _run(False)
    fused, devs, got = _run(True)
    assert got == want
    assert sum(len(k) + len(r) for store in got for k, r in store) > 0
    assert solo.n_fused_launches == 0 and solo.n_solo_flushes == 3 * STORES
    assert fused.n_fused_launches == 3 and fused.n_solo_flushes == 0
    assert fused.n_fused_members == 3 * STORES
    assert all(d.n_fused_flushes == 3 for d in devs)


def test_fusion_off_pins_solo(monkeypatch):
    _force_pays(monkeypatch)
    monkeypatch.setenv("ACCORD_TPU_FUSION", "off")
    from accord_tpu_torch.local.dispatch import fusion_enabled
    assert not fusion_enabled()
    disp, _devs, _got = _run(None, rounds=1)
    assert not disp.fusion
    assert disp.n_fused_launches == 0 and disp.n_solo_flushes == STORES
    monkeypatch.delenv("ACCORD_TPU_FUSION")
    assert fusion_enabled() and cs.LaunchNode().dispatcher.fusion


class _RecordingSafe:
    """Records every candidate the tick looks up; no records, so the
    re-check is a no-op."""

    def __init__(self, store):
        self.store = store
        self.asked = set()

    def if_present(self, txn_id):
        self.asked.add((txn_id.msb, txn_id.lsb, txn_id.node))
        return None


def _chain(dev, ts, depth=6):
    ids = [ts.TxnId.create(1, 100 + i, ts.TxnKind.Write, ts.Domain.Key, 1)
           for i in range(depth)]
    slots = [dev.drain.alloc(t) for t in ids]
    for a, b in zip(slots[1:], slots):
        dev.drain.add_edge(a, b)
    for t, s in zip(ids, slots):
        dev.drain.set_status(s, 4, t)      # Stable, executeAt = id
        dev.drain.active[s] = True
    return ids


def test_widened_tick_proposes_reference_candidates(monkeypatch):
    monkeypatch.delenv("ACCORD_TPU_DRAIN", raising=False)
    from accord_tpu.primitives import timestamp as rts
    from accord_tpu_torch.primitives import timestamp as pts
    from tests.conftest import make_device_state
    _rs, ref, _rsafe = make_device_state(mesh=None)
    port = cs.P.DeviceState(cs.Store(), device="cpu")
    got = {}
    for dev, ts in ((ref, rts), (port, pts)):
        _chain(dev, ts)
        dev._drain_wavefront = 4
        safe = _RecordingSafe(dev.store)
        dev._tick(safe)
        assert dev.n_wavefront_ticks == 1 and dev.n_host_ticks == 0
        got[dev is port] = safe.asked
    assert got[True] == got[False] and len(got[True]) == 4
    assert port.n_device_ticks == 1
    assert port._drain_wavefront == 1       # nothing applied: W resets


@pytest.mark.parametrize("hatch", [None, "fixpoint"])
def test_wavefront_doubles_unless_fixpoint(monkeypatch, hatch):
    """Every proposed txn applies at once (the cascade regime): by default
    W doubles each tick and the 6-chain drains in 3 ticks, 2 of them
    widened; under the escape hatch every tick sweeps one level."""
    if hatch is None:
        monkeypatch.delenv("ACCORD_TPU_DRAIN", raising=False)
    else:
        monkeypatch.setenv("ACCORD_TPU_DRAIN", hatch)
    store, ds, ids = cs.chain_store(6, "cpu")
    store.apply = True
    seen = []
    while store.due:
        store.run_ticks()
        seen.append(ds._drain_wavefront)
    assert store.applied == ids
    if hatch is None:
        assert seen[:3] == [2, 4, 8] and ds.n_wavefront_ticks == 2
    else:
        assert set(seen) == {1} and ds.n_wavefront_ticks == 0
        assert len(seen) >= 6


def test_fused_relaunch_reads_the_table_as_of_dispatch(monkeypatch):
    """A fused member whose learned budgets overflow re-launches solo in
    its harvest task, after later registrations were scattered into its
    device table in place: the lease taken at dispatch makes that scatter
    copy the table first, so the re-launch answers for the dispatch-time
    table (the oracle: the same flush with nothing in between)."""
    _force_pays(monkeypatch)

    def flush(interleave):
        node, devs = cs.launch_harness(2, NPER, KEYS, True, "cpu")
        for dev in devs:
            cs.drive_flushes(node, [dev], 1, KEYS, seed=3)   # uploads
            dev._batch_flat, dev._batch_k = 1, 1             # force overflow
        rng = np.random.default_rng(5)
        builders = [[] for _ in devs]
        for i, dev in enumerate(devs):
            for _ in range(4):
                bound = cs.P.TxnId.create(1, 1_500_000, cs.P.TxnKind.Write,
                                          cs.P.Domain.Key, 1)
                b = cs.P.DepsBuilder()
                builders[i].append(b)
                dev.enqueue_query((bound, bound, bound.kind().witnesses(),
                                   [int(rng.integers(0, KEYS))], []), b,
                                  lambda f, s: None)
        sched = node.scheduler
        sched.q.pop(0)()                     # the dispatcher event only
        assert node.dispatcher.n_fused_launches == 1
        table = devs[0].deps._device
        if interleave:
            # overlapping writes below every bound, in free slots, then
            # scattered into the device table before the harvest
            for h in range(12):
                tid = cs.P.TxnId.create(1, 10 + h, cs.P.TxnKind.Write,
                                        cs.P.Domain.Key, 1)
                devs[0].register(tid, int(cs.P.InternalStatus.PREACCEPTED),
                                 cs.P.Keys([cs.P.IntKey(h % KEYS)]))
            devs[0].deps.device_table()
            assert devs[0].deps._device is not table      # copied first
        sched.run()                          # the harvests
        assert devs[0]._batch_flat > 1                    # re-launched
        assert not devs[0].deps._leases                   # returned
        return [cs.deps_digest(b) for b in builders]

    assert flush(True) == flush(False)


def test_fused_launch_fault_fails_every_member_over(monkeypatch):
    """An injected kernel-launch fault inside a fused flush fails the
    whole batch over to the host route: every member quarantines and
    builds the same Deps as the fault-free fused run."""
    from accord_tpu_torch.utils import faults
    from accord_tpu_torch.utils.random_source import RandomSource
    _force_pays(monkeypatch)
    _disp, _devs, want = _run(True, rounds=1)
    node, devs = cs.launch_harness(STORES, NPER, KEYS, True, "cpu")
    with faults.device_fault("kernel_launch", 1.0, RandomSource(0xDEC0)):
        built = cs.drive_flushes(node, devs, 1, KEYS, seed=7)
    assert [cs.deps_digest(b) for b in built] == want
    assert node.dispatcher.n_fused_launches == 0
    assert all(d.n_device_faults == 1 and d.n_fallback_queries == 4
               and d._dev_quar_flushes > 0 and not d.deps._leases
               for d in devs)
