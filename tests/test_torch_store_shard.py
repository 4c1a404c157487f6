"""The port's store-sharded residency (``parallel/store_shard.py`` and the
ladder's spill rung) against the JAX package's.

The reference runs on the conftest's 8 virtual CPU devices; the port runs
on an 8-slice CPU mesh.  Each case drives the same registrations into both
packages and holds the packed CSR and the attributed Deps byte-equal to
the reference's and to the port's own host oracle: the spill rung, the
mesh-budget host pin, the un-terminal recovery, the escape hatch, a slice
fault whose hybrid flush (healthy slices on device, the sick slice's
slots from the host twin) gives the same bytes, a scaled-down property
sweep, bench config 5b at 2^14 slots against a 2^11 budget, the mesh
routes under one injected calibration, and the per-slice lease of a
pipelined re-launch."""

import os

import numpy as np
import pytest

import accord_tpu
import accord_tpu_torch
from accord_tpu_torch.parallel import sharded as psh

from tests.proptest import case_budget, run_property

pytestmark = pytest.mark.skipif(
    os.environ.get("ACCORD_TPU_STORE_SHARD", "").lower()
    in ("off", "0", "false", "no"),
    reason="ACCORD_TPU_STORE_SHARD=off canary run: spill rung dormant")

PKGS = (accord_tpu, accord_tpu_torch)
SPILL_BUDGET = 64


def _mods(pkg):
    from importlib import import_module
    n = pkg.__name__
    return dict(di=import_module(n + ".local.device_index"),
                cfk=import_module(n + ".local.commands_for_key"),
                keys=import_module(n + ".primitives.keys"),
                ts=import_module(n + ".primitives.timestamp"),
                deps=import_module(n + ".primitives.deps"),
                rb=import_module(n + ".local.redundant"),
                dk=import_module(n + ".ops.deps_kernel"))


class _Store:
    def __init__(self, pkg):
        self.commands_for_key = {}
        self.redundant_before = _mods(pkg)["rb"].RedundantBefore()

    class node:
        scheduler = None


class _Safe:
    def __init__(self, store):
        self.store = store

    def redundant_before(self):
        return self.store.redundant_before


def _state(pkg, mesh=True):
    """(store, dev, safe): the reference keeps its conftest mesh (or
    none); the port gets an 8-slice CPU mesh (or none)."""
    store = _Store(pkg)
    di = _mods(pkg)["di"]
    if pkg is accord_tpu:
        dev = di.DeviceState(store)
        if not mesh:
            dev.mesh = None
    else:
        dev = di.DeviceState(store, device="cpu",
                             mesh=psh.make_mesh(8, "cpu") if mesh else None)
    return store, dev, _Safe(store)


def _register_n(pkg, dev, n, hlc_base, keyspace=4096):
    md = _mods(pkg)
    ts, keys = md["ts"], md["keys"]
    for i in range(n):
        tid = ts.TxnId.create(1, hlc_base + i, ts.TxnKind.Write,
                              ts.Domain.Key, 1 + (i % 5))
        dev.register(tid, int(md["cfk"].InternalStatus.PREACCEPTED),
                     keys.Keys([keys.IntKey((i * 37) % keyspace)]))


def _queries(pkg, toks):
    ts = _mods(pkg)["ts"]
    bound = ts.TxnId.create(1, 10_000_000, ts.TxnKind.Write, ts.Domain.Key,
                            1)
    return [(bound, bound, bound.kind().witnesses(), [t], []) for t in toks]


def _csr(dev, qs, prune=True):
    h = dev.deps_query_batch_begin(qs, immediate=True, prune_floors=prune)
    return [np.asarray(x) for x in dev.deps_query_batch_end(h)[:2]]


def _attributed(pkg, dev, safe, qs, prune=True):
    builders = [_mods(pkg)["deps"].DepsBuilder() for _ in qs]
    h = dev.deps_query_batch_begin(qs, immediate=True, prune_floors=prune,
                                   attributed=True)
    dev.deps_query_batch_end_attributed(safe, h, builders)
    out = []
    for b in builders:
        deps = b.build()
        out.append(([(k, tuple(str(t) for t in deps.key_deps.txn_ids_for(k)))
                     for k in deps.key_deps.keys.tokens()],
                    [(r.start, r.end,
                      tuple(str(deps.range_deps.txn_ids[j]) for j in row))
                     for r, row in zip(deps.range_deps.ranges,
                                       deps.range_deps._per_range)]))
    return out


TOKS = [(i * 37) % 4096 for i in range(6)]


def _both(fn):
    return {pkg: fn(pkg) for pkg in PKGS}


# -- the spill rung and the mesh-budget host pin ------------------------------

def test_budget_breach_spills_to_sharded_not_host():
    def run(pkg):
        store, dev, safe = _state(pkg)
        dev.route_override = "dense"
        dev.device_budget_slots = 128
        _register_n(pkg, dev, 300, hlc_base=1)
        assert not dev.host_pinned and dev.n_oom_degraded == 0
        assert dev.store_shards is not None and dev.store_shards.active
        assert 128 < dev.deps.capacity <= 128 * dev.store_shards.d
        assert dev.store_shards.d == 8
        qs = _queries(pkg, TOKS)
        out = (_attributed(pkg, dev, safe, qs), _csr(dev, qs))
        assert dev.n_store_sharded_flushes >= 2
        assert dev.n_shard_merge_bytes > 0
        dev.route_override = "host"
        assert _attributed(pkg, dev, safe, qs) == out[0]
        return out
    got = _both(run)
    assert got[accord_tpu][0] == got[accord_tpu_torch][0]
    for a, b in zip(got[accord_tpu][1], got[accord_tpu_torch][1]):
        np.testing.assert_array_equal(a, b)


def test_sharded_store_breaching_mesh_budget_pins_to_host():
    for pkg in PKGS:
        store, dev, safe = _state(pkg)
        dev.route_override = "dense"
        dev.device_budget_slots = 32
        _register_n(pkg, dev, 300, hlc_base=1)     # 512 slots > 32 * 8
        assert dev.host_pinned and dev.n_oom_degraded == 1, pkg


def test_escape_hatch_disables_spill(monkeypatch):
    monkeypatch.setenv("ACCORD_TPU_STORE_SHARD", "off")
    from accord_tpu_torch.parallel.store_shard import store_shard_enabled
    assert not store_shard_enabled()
    for pkg in PKGS:
        store, dev, safe = _state(pkg)
        dev.route_override = "dense"
        dev.device_budget_slots = 128
        _register_n(pkg, dev, 300, hlc_base=1)
        assert dev.host_pinned and dev.n_oom_degraded == 1
        assert dev.store_shards is None or not dev.store_shards.active


# -- recovery ------------------------------------------------------------------

def _drain_recheck(pkg, dev, safe, qs, limit=200):
    ref = _attributed(pkg, dev, safe, qs)
    for _ in range(limit):
        if not dev.host_pinned:
            break
        assert _attributed(pkg, dev, safe, qs) == ref
    return ref


@pytest.mark.parametrize("raise_to,spill", [(1 << 16, False), (128, True)])
def test_host_pin_recovers(raise_to, spill):
    """A pinned store unpins at the periodic recheck once the budget
    fits its capacity — on one device, or by activating the shards when
    only budget x d fits — and answers as before."""
    def run(pkg):
        store, dev, safe = _state(pkg, mesh=spill)
        dev.route_override = "dense"
        dev.device_budget_slots = 32 if spill else 128
        _register_n(pkg, dev, 300 if spill else 200, hlc_base=1)
        assert dev.host_pinned
        dev.device_budget_slots = raise_to
        qs = _queries(pkg, TOKS[:4])
        ref = _drain_recheck(pkg, dev, safe, qs)
        assert not dev.host_pinned and dev.n_oom_recovered == 1
        assert _attributed(pkg, dev, safe, qs) == ref
        if spill:
            assert dev.store_shards.active
            assert dev.n_store_sharded_flushes >= 1
        return ref
    got = _both(run)
    assert got[accord_tpu] == got[accord_tpu_torch]


def test_host_pin_recovery_respects_escape_hatch(monkeypatch):
    monkeypatch.setenv("ACCORD_TPU_STORE_SHARD", "off")
    store, dev, safe = _state(accord_tpu_torch)
    dev.route_override = "dense"
    dev.device_budget_slots = 32
    _register_n(accord_tpu_torch, dev, 300, hlc_base=1)
    assert dev.host_pinned
    dev.device_budget_slots = 64           # still < capacity 512
    qs = _queries(accord_tpu_torch, [37])
    for _ in range(130):                   # past the first recheck window
        _attributed(accord_tpu_torch, dev, safe, qs)
    assert dev.host_pinned and dev.n_oom_recovered == 0


# -- a slice fault: the hybrid flush ---------------------------------------------

def test_slice_fault_hybrid_flush_same_bytes():
    """A device-boundary fault attributed to slice 3 quarantines that
    slice only: the next attributed flushes are hybrid (slice 3's status
    masked to FREE on device, its slots answered by the host twin), the
    raw CSR path serves from host, and every answer equals the unfaulted
    one; the slice re-probes and is restored after its backoff."""
    def run(pkg):
        store, dev, safe = _state(pkg)
        dev.route_override = "dense"
        dev.device_budget_slots = 128
        _register_n(pkg, dev, 300, hlc_base=1)
        qs = _queries(pkg, TOKS)
        clean = _attributed(pkg, dev, safe, qs)
        clean_csr = _csr(dev, qs)
        sh = dev.store_shards
        sh.last_slice_touched = 3
        dev._device_fault("transfer", "slice 3 upload", sliced=True)
        assert sh.quarantined_slices() == [3]
        assert dev.n_slice_quarantines == 1 and dev._dev_quar_flushes == 0
        hybrid = [_attributed(pkg, dev, safe, qs) for _ in range(3)]
        assert all(h == clean for h in hybrid)
        for a, b in zip(_csr(dev, qs), clean_csr):
            np.testing.assert_array_equal(a, b)
        for _ in range(400):
            if not sh.any_quarantined() and not any(sh.suspect):
                break
            assert _attributed(pkg, dev, safe, qs) == clean
        assert dev.n_slice_restores == 1
        return clean, dev.n_store_sharded_flushes, dev.n_slice_quarantines
    got = _both(run)
    assert got[accord_tpu] == got[accord_tpu_torch]


def test_slice_bookkeeping_unit():
    store, dev, safe = _state(accord_tpu_torch)
    dev.route_override = "dense"
    dev.device_budget_slots = 128
    _register_n(accord_tpu_torch, dev, 300, hlc_base=1)
    sh = dev.store_shards
    assert sh.active and not sh.any_quarantined()
    sn = sh.slice_n()
    assert sn * sh.d == dev.deps.capacity
    # the assembled table is the tuple of the resident slices
    t = dev.deps.device_table_sharded(dev.mesh)
    assert len(t.msb) == 8 and t.msb[0] is sh._tables[0].msb
    sh.quar[3] = 5
    t = dev.deps.device_table_sharded(dev.mesh)
    assert bool((t.status[3] == -1).all())
    assert t.status[2] is sh._tables[2].status
    cj = np.array([0, sn - 1, 3 * sn, 4 * sn - 1, 4 * sn], np.int64)
    np.testing.assert_array_equal(
        sh.quarantined_slot_mask(cj),
        np.array([False, False, True, True, False]))
    sh.quar[3] = 0


def test_c_shard_and_rtt_mesh_measured():
    store, dev, safe = _state(accord_tpu_torch)
    saved = dev._CALIB
    try:
        type(dev)._CALIB = None
        calib = dev._calibration()
        assert calib["c_shard"] > 0.0 and calib["rtt_mesh"] > 0.0
    finally:
        type(dev)._CALIB = saved


# -- the property sweep (scaled down) --------------------------------------------

def _replay(pkg, case, mode):
    md = _mods(pkg)
    ts, keys, cfk = md["ts"], md["keys"], md["cfk"]
    store, dev, safe = _state(pkg, mesh=mode != "single")
    dev.route_override = "host" if mode == "host" else "dense"
    if mode == "sharded":
        dev.device_budget_slots = SPILL_BUDGET
    tids = {}
    for op in case.ops:
        if op[0] == "reg":
            _, hlc, kind, dom, spec, nslot = op
            tid = ts.TxnId.create(1, hlc, ts.TxnKind(int(kind)),
                                  ts.Domain(int(dom)), nslot)
            tids[hlc] = tid
            k = keys.Keys([keys.IntKey(t) for t in spec[1]]) \
                if spec[0] == "keys" else \
                keys.Ranges.of(keys.Range(spec[1], spec[2]))
            dev.register(tid, int(cfk.InternalStatus.PREACCEPTED), k)
        elif op[0] == "inval":
            dev.update_status(tids[op[1]],
                              int(cfk.InternalStatus.INVALIDATED))
        else:
            floor = ts.TxnId.create(1, op[1], ts.TxnKind.ExclusiveSyncPoint,
                                    ts.Domain.Range, 1)
            store.redundant_before.add_redundant(
                keys.Ranges.of(keys.Range(-(1 << 60), 1 << 60)), floor)
    qs = []
    for (b, _s, _w, toks, rngs) in case.queries:
        bound = ts.TxnId.create(1, int(b.hlc()), ts.TxnKind.Write,
                                ts.Domain.Key, 1)
        qs.append((bound, bound, bound.kind().witnesses(), list(toks),
                   [keys.Range(r.start, r.end) for r in rngs]))
    return dev, _csr(dev, qs), _attributed(pkg, dev, safe, qs)


def _check_case(case):
    ref_dev, ref_csr, ref_attr = _replay(accord_tpu, case, "sharded")
    dev, got_csr, got_attr = _replay(accord_tpu_torch, case, "sharded")
    assert not dev.host_pinned, "spill rung skipped: store pinned to host"
    assert (dev.store_shards is not None and dev.store_shards.active) == \
        (ref_dev.store_shards is not None and ref_dev.store_shards.active)
    _d2, host_csr, host_attr = _replay(accord_tpu_torch, case, "host")
    _d3, one_csr, one_attr = _replay(accord_tpu_torch, case, "single")
    for trio in zip(ref_csr, got_csr, host_csr, one_csr):
        for x in trio[1:]:
            np.testing.assert_array_equal(trio[0], x)
    assert got_attr == ref_attr == host_attr == one_attr


def test_property_sharded_routes_byte_identical():
    from tests.test_store_shard import ShardCase
    run_property(case_budget(2), base_seed=0x57A6D, make_case=ShardCase,
                 check=_check_case,
                 replay_hint="pytest tests/test_torch_store_shard.py")


# -- bench config 5b, scaled down --------------------------------------------------

def config5b(pkg, n, budget, b5, keys5):
    """``bench.bench_store_sharded`` at ``n`` slots against ``budget``:
    the ladder walk, the bulk fill, the host-oracle CSR and the pinned
    dense (sharded) CSR over the same ``b5`` pruned queries."""
    md = _mods(pkg)
    ts, dk = md["ts"], md["dk"]
    store, dev, _safe = _state(pkg)
    dev.device_budget_slots = budget
    dev.route_override = "dense"
    m = dev.deps
    while m.capacity < n:
        m.free_slots.clear()      # force the grow (no compacted slack)
        m._grow_capacity()
    assert dev.store_shards is not None and dev.store_shards.active
    assert not dev.host_pinned
    rng = np.random.default_rng(13)
    hlc = rng.choice(np.arange(1, 4 * n, dtype=np.int64), size=n,
                     replace=False)
    flags = np.int64((int(ts.TxnKind.Write) << 1) | int(ts.Domain.Key))
    m.msb[:] = np.int64(1) << 16
    m.lsb[:] = (hlc << 16) | flags
    m.node[:] = (np.arange(n) % 5 + 1).astype(np.int32)
    m.kind[:] = int(ts.TxnKind.Write)
    m.domain[:] = int(ts.Domain.Key)
    m.status[:] = dk.SLOT_TRANSITIVE
    toks = rng.integers(0, keys5, size=n).astype(np.int64)
    m.lo[:, 0] = toks
    m.hi[:, 0] = toks
    m.free_slots = []
    m.n_live = n
    m.version += 1
    m.mut_version += 1
    m._snap = None
    m._device = None
    m._device_sh = None
    m._dirty.clear()
    m._dirty_sh.clear()
    m._attr_dirty_sh.clear()
    queries = []
    for _ in range(b5):
        bound = ts.TxnId.create(1, int(rng.integers(5 * n, 6 * n)),
                                ts.TxnKind.Write, ts.Domain.Key, 1)
        queries.append((bound, bound, bound.kind().witnesses(),
                        [int(rng.integers(0, keys5))], []))
    dev.route_override = "host"
    host_csr = _csr(dev, queries)
    dev.route_override = "dense"
    shard_csr = _csr(dev, queries)
    assert dev.n_store_sharded_flushes >= 1
    return host_csr, shard_csr, dev.store_shards.d


def test_config5b_scaled():
    got = {pkg: config5b(pkg, 1 << 14, 1 << 11, 64, 1 << 16)
           for pkg in PKGS}
    (rh, rs, rd), (ph, ps, pd) = got[accord_tpu], got[accord_tpu_torch]
    assert rd == pd == 8
    for a, b, c, e in zip(rh, rs, ph, ps):
        for x in (b, c, e):
            np.testing.assert_array_equal(a, x)
    assert len(ps[1]) > 0


# -- routing: the same prices give the same routes --------------------------------

@pytest.mark.parametrize("cal", [(2e-3, 1e-8, 1e-10, 5e-3, 1e-9),
                                 (1e-5, 1e-7, 1e-11, 2e-5, 1e-12)])
def test_mesh_routes_equal_under_one_calibration(cal):
    """The mesh probes time each package's own launches, so on a real
    device the two may route differently (their results never differ).
    Given one calibration, the mesh deps route and the mesh-tick choice
    are the reference's."""
    from accord_tpu.local import device_index as rdi
    from accord_tpu_torch.local import device_index as pdi
    saved = (rdi.DeviceState._CALIB, pdi.DeviceState._CALIB)
    try:
        for cls in (rdi.DeviceState, pdi.DeviceState):
            cls.set_route_calibration(rtt=cal[0], c_host=cal[1],
                                      c_dev=cal[2], rtt_mesh=cal[3],
                                      c_shard=cal[4])
        got = {}
        for pkg in PKGS:
            md = _mods(pkg)
            store, dev, safe = _state(pkg)
            _register_n(pkg, dev, 300, hlc_base=1)
            qs = _queries(pkg, TOKS)
            packed = [(sb, wit, toks, rngs, tid)
                      for (tid, sb, wit, toks, rngs) in qs]
            qnp = md["dk"].pack_query_matrix(packed, 1)
            got[pkg] = ([dev._choose_route(qnp[:k], 1, None)
                         for k in (1, 3, 6)],
                        [dev._mesh_tick_pays(n)
                         for n in (64, 1024, 4096, 16384)])
        assert got[accord_tpu] == got[accord_tpu_torch]
    finally:
        rdi.DeviceState._CALIB, pdi.DeviceState._CALIB = saved


def _builders_of(pkg, n):
    return [_mods(pkg)["deps"].DepsBuilder() for _ in range(n)]


def test_relaunch_reads_the_slices_as_of_begin():
    """The slices are scatter-updated in place: a pipelined sharded batch
    that overflows its budgets re-launches after later registrations were
    scattered into a slice, and must answer for the slices as of begin
    (the mirror's lease, per slice: the scatter copies a leased slice)."""
    pkg = accord_tpu_torch
    store, dev, safe = _state(pkg)
    dev.route_override = "dense"
    dev.device_budget_slots = 128
    _register_n(pkg, dev, 300, hlc_base=1)
    sh = dev.store_shards
    assert sh.active and sh.slice_n() == 64
    qs = _queries(pkg, TOKS)
    want = _attributed(pkg, dev, safe, qs)          # uploads the slices
    dev._batch_flat, dev._batch_k = 1, 1            # force the re-launch
    builders = _builders_of(pkg, len(qs))
    h = dev.deps_query_batch_begin(qs, prune_floors=True, attributed=True)
    at_begin = list(sh._tables)
    _register_n(pkg, dev, 8, hlc_base=1_000)        # slots 300-307: slice 4
    _attributed(pkg, dev, safe, qs[:2])             # scatters into slice 4
    assert sh._tables[4] is not at_begin[4]         # copied first
    assert sh._tables[0] is at_begin[0]
    dev.deps_query_batch_end_attributed(safe, h, builders)
    assert dev._batch_flat > 1                      # re-launched
    got = []
    for b in builders:
        deps = b.build()
        got.append([(k, tuple(str(t) for t in deps.key_deps.txn_ids_for(k)))
                    for k in deps.key_deps.keys.tokens()])
    assert got == [w[0] for w in want]
    assert _attributed(pkg, dev, safe, qs) != want  # the new rows count now
