"""The port's DeviceState against the JAX package's on the same store.

A store is built in both packages from one seed, the way
``tests/test_routing._build`` builds it (mixed point / range footprints,
stragglers, invalidated slots, a RedundantBefore floor over the whole key
space), with the reference pinned to its single-device path
(``dev.mesh = None``) and the slice's escape hatches set.  For every route
(host, device, dense) the built ``Deps`` of the attributed batch scan and
the raw packed CSR must equal the reference's.  The port runs on the CPU
here, so its device routes take the plain versions of its kernels."""

import numpy as np
import pytest
import torch

import accord_tpu
import accord_tpu_torch

ROUTES = ("host", "device", "dense")


@pytest.fixture(autouse=True)
def _slice_config(monkeypatch):
    monkeypatch.setenv("ACCORD_TPU_FUSION", "off")
    monkeypatch.setenv("ACCORD_TPU_DRAIN", "fixpoint")
    monkeypatch.setenv("ACCORD_TPU_STORE_SHARD", "off")


class _Store:
    def __init__(self, pkg):
        from importlib import import_module
        rb = import_module(pkg.__name__ + ".local.redundant")
        self.commands_for_key = {}
        self.redundant_before = rb.RedundantBefore()

    class node:
        scheduler = None


class _Safe:
    def __init__(self, store):
        self.store = store

    def redundant_before(self):
        return self.store.redundant_before


def _mods(pkg):
    from importlib import import_module
    n = pkg.__name__
    return (import_module(n + ".local.device_index"),
            import_module(n + ".local.commands_for_key"),
            import_module(n + ".primitives.keys"),
            import_module(n + ".primitives.timestamp"),
            import_module(n + ".primitives.deps"))


def _build(pkg, seed, n=220, keyspace=6_000, nq=28):
    """(dev, safe, queries, register) for ``pkg`` — the same seeded
    content whichever package builds it."""
    di, cfk, keys, ts, _deps = _mods(pkg)
    rng = np.random.default_rng(seed)
    store = _Store(pkg)
    if pkg is accord_tpu:
        dev = di.DeviceState(store)
        dev.mesh = None
    else:
        dev = di.DeviceState(store, device="cpu")
    safe = _Safe(store)
    TxnId, TxnKind, Domain = ts.TxnId, ts.TxnKind, ts.Domain
    Range, Ranges, Keys, IntKey = keys.Range, keys.Ranges, keys.Keys, keys.IntKey

    def register(count, hlc_lo, hlc_hi):
        hlcs = rng.choice(np.arange(hlc_lo, hlc_hi), size=count,
                          replace=False)
        for i in range(count):
            kind = TxnKind.Write if rng.random() < 0.7 else TxnKind.Read
            r = rng.random()
            if r < 0.12:
                s = int(rng.integers(0, keyspace // 2))
                toks, rngs = [], [Range(s, s + keyspace // 3)]
                dom = Domain.Range
            elif r < 0.5:
                toks = [int(t) for t in rng.integers(0, keyspace,
                                                     rng.integers(1, 4))]
                rngs, dom = [], Domain.Key
            else:
                s = int(rng.integers(0, keyspace - 70))
                toks = []
                rngs = [Range(s, s + int(rng.integers(1, 70)))]
                dom = Domain.Range
            tid = TxnId.create(1, int(hlcs[i]), kind, dom,
                               1 + int(rng.integers(0, 5)))
            k = Ranges.of(*rngs) if rngs else Keys([IntKey(t) for t in toks])
            dev.register(tid, int(cfk.InternalStatus.PREACCEPTED), k)
            if rng.random() < 0.08:
                dev.update_status(tid, int(cfk.InternalStatus.INVALIDATED))
            elif rng.random() < 0.3:
                dev.update_status(tid, int(cfk.InternalStatus.COMMITTED),
                                  TxnId.create(1, int(hlcs[i]) + 7, kind,
                                               dom, 1))

    register(n, 1, 40 * n)
    floor = TxnId.create(1, int(10 * n), TxnKind.ExclusiveSyncPoint,
                         Domain.Range, 1)
    store.redundant_before.add_redundant(
        Ranges.of(Range(-(1 << 60), 1 << 60)), floor)
    qs = []
    for _ in range(nq):
        bound = TxnId.create(1, int(rng.integers(40 * n, 80 * n)),
                             TxnKind.Write, Domain.Key, 1)
        toks, rngs = [], []
        for _ in range(int(rng.integers(1, 4))):
            r = rng.random()
            if r < 0.15:
                s = int(rng.integers(0, keyspace // 2))
                rngs.append(Range(s, s + keyspace // 3))
            elif r < 0.6:
                toks.append(int(rng.integers(0, keyspace)))
            else:
                s = int(rng.integers(0, keyspace - 70))
                rngs.append(Range(s, s + int(rng.integers(1, 70))))
        qs.append((bound, bound, bound.kind().witnesses(), toks, rngs))
    return dev, safe, qs, register


def _tid(t):
    return (t.msb, t.lsb, t.node)


def _unpack(builders):
    out = []
    for b in builders:
        deps = b.build()
        out.append(([(k, tuple(map(_tid, deps.key_deps.txn_ids_for(k))))
                     for k in deps.key_deps.keys.tokens()],
                    [(r.start, r.end,
                      tuple(_tid(deps.range_deps.txn_ids[j]) for j in row))
                     for r, row in zip(deps.range_deps.ranges,
                                       deps.range_deps._per_range)]))
    return out


def _attributed(pkg, dev, safe, qs, immediate):
    DepsBuilder = _mods(pkg)[4].DepsBuilder
    builders = [DepsBuilder() for _ in qs]
    h = dev.deps_query_batch_begin(qs, immediate=immediate,
                                   prune_floors=True, attributed=True)
    dev.deps_query_batch_end_attributed(safe, h, builders)
    return _unpack(builders)


@pytest.mark.parametrize("seed", [3, 11])
def test_routes_build_equal_deps(seed):
    ref, rsafe, rqs, _ = _build(accord_tpu, seed)
    port, psafe, pqs, _ = _build(accord_tpu_torch, seed)
    want = None
    for route in ROUTES:
        ref.route_override = route
        port.route_override = route
        for immediate in (True, False):
            a = _attributed(accord_tpu, ref, rsafe, rqs, immediate)
            b = _attributed(accord_tpu_torch, port, psafe, pqs, immediate)
            assert a == b, (route, immediate)
            want = want or a
            assert b == want, (route, immediate)
        # the raw packed CSR (no floors / attribution)
        h = ref.deps_query_batch_begin(rqs, immediate=True)
        ra = ref.deps_query_batch_end(h)
        h = port.deps_query_batch_begin(pqs, immediate=True)
        pa = port.deps_query_batch_end(h)
        for x, y in zip(ra, pa):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert sum(len(k) + len(r) for k, r in want) > 0
    assert port.n_bucketed_queries and port.n_dense_queries \
        and port.n_host_queries


def test_relaunch_reads_the_table_as_of_begin():
    """The scatter kernel writes in place: a pipelined batch that overflows
    its learned budgets re-launches after later registrations were
    scattered into the device table, and must still answer for the table
    as it was at begin, as the reference's functional update does.

    The oracle is the reference answering the same batch on the same store
    with nothing interleaved: the reference cannot run the interleaved
    sequence itself on the CPU, where ``jnp.asarray`` may alias the
    mirror's host arrays (for some allocations, depending on their
    alignment) and its table then sees the later registrations."""
    ref, rsafe, rqs, _ = _build(accord_tpu, 5)
    ref.route_override = "device"
    want = _attributed(accord_tpu, ref, rsafe, rqs, True)
    dev, safe, qs, register = _build(accord_tpu_torch, 5)
    dev.route_override = "device"
    _attributed(accord_tpu_torch, dev, safe, qs[:4], True)   # uploads
    dev._batch_flat, dev._batch_k = 1, 1                    # force overflow
    DepsBuilder = _mods(accord_tpu_torch)[4].DepsBuilder
    builders = [DepsBuilder() for _ in qs]
    h = dev.deps_query_batch_begin(qs, prune_floors=True, attributed=True)
    table_at_begin = dev.deps._device
    register(60, 10_000, 10_500)   # overlapping, below every bound
    _attributed(accord_tpu_torch, dev, safe, qs[:2], True)  # scatters rows
    assert dev.deps._device is not table_at_begin           # copied first
    dev.deps_query_batch_end_attributed(safe, h, builders)
    assert dev._batch_flat > 1                              # re-launched
    assert _unpack(builders) == want


def test_collected_batch_releases_its_table():
    """Only a launched, not yet collected pipelined batch holds the device
    table: once it is collected, and for immediate flushes at all, the next
    scatter writes into the cached table in place instead of copying it."""
    dev, safe, qs, register = _build(accord_tpu_torch, 5)
    dev.route_override = "device"
    _attributed(accord_tpu_torch, dev, safe, qs[:4], True)   # uploads
    assert not dev.deps._leases                  # immediate: no lease
    DepsBuilder = _mods(accord_tpu_torch)[4].DepsBuilder
    h = dev.deps_query_batch_begin(qs, prune_floors=True, attributed=True)
    assert dev.deps._leases
    dev.deps_query_batch_end_attributed(safe, h,
                                        [DepsBuilder() for _ in qs])
    assert not dev.deps._leases
    table = dev.deps._device
    register(8, 10_000, 10_500)
    _attributed(accord_tpu_torch, dev, safe, qs[:2], True)  # scatters rows
    assert dev.deps._device is table                        # in place


def test_bucket_table_carries_its_plan():
    """The mirror's bucket table is one planned tuple while its columns
    stay the same tensors (a scatter writes them in place), and a new
    planned tuple once a lease makes the next scatter copy them."""
    from accord_tpu_torch.ops import kernels
    dev, safe, qs, register = _build(accord_tpu_torch, 5)
    dev.route_override = "device"
    _attributed(accord_tpu_torch, dev, safe, qs[:4], True)   # uploads
    bt = dev.deps.bucket_device()
    assert bt._plan is not None and dev.deps.bucket_device() is bt
    register(8, 10_000, 10_500)
    now = dev.deps.bucket_device()              # rows scattered in place,
    assert now._plan is not None                # or a wide list re-made
    assert (now is bt) == (now.blo is bt.blo and now.wlo is bt.wlo)
    lease = dev.deps.share_device((now,))
    register(8, 10_500, 11_000)
    again = dev.deps.bucket_device()
    dev.deps.release_device(lease)
    assert again is not now and again.blo is not now.blo
    assert kernels._cols_on(again, torch.device("cpu"))[0] == [
        c.data_ptr() for c in again]


def test_drain_tick_frontier_equal():
    """The drain mirror's state() feeds the port's frontier kernels the
    same graph the reference's does, dense and ELL, scalar deltas
    included."""
    from accord_tpu.local import device_index as rdi
    from accord_tpu_torch.local import device_index as pdi
    from accord_tpu.primitives.timestamp import TxnId as RT, TxnKind as RK, \
        Domain as RD
    from accord_tpu_torch.primitives.timestamp import TxnId as PT, \
        TxnKind as PK, Domain as PD
    rng = np.random.default_rng(2)
    for n in (40, 9000):
        mr = rdi._DrainMirror()
        mp = pdi._DrainMirror(device="cpu")
        ids = rng.choice(np.arange(1, 10 * n), n, replace=False)
        st = rng.integers(0, 7, n)
        ex = rng.integers(1, 6, n)
        for m, T, K, D in ((mr, RT, RK, RD), (mp, PT, PK, PD)):
            slots = [m.alloc(T.create(1, int(h), K.Write, D.Key, 1))
                     for h in ids]
            for i, s in enumerate(slots):
                m.set_status(s, int(st[i]),
                             T.create(1, int(ex[i]), K.Write, D.Key, 1))
                for j in range(i % 3):
                    m.add_edge(s, slots[(i * 7 + j) % (i + 1)])
        for step in range(2):
            sr, lr = mr.state()
            sp, lp = mp.state()
            np.testing.assert_array_equal(lr, lp)
            fr = (rdi.drk.ready_frontier_ell(sr)
                  if isinstance(sr, rdi.drk.EllDrainState)
                  else rdi.drk.ready_frontier(sr))
            fp = (pdi.drk.ready_frontier_ell(sp)
                  if isinstance(sp, pdi.drk.EllDrainState)
                  else pdi.drk.ready_frontier(sp))
            np.testing.assert_array_equal(np.asarray(fr), fp.numpy())
            # a scalar delta: status moves take the scatter path next time
            for m in (mr, mp):
                for s in range(0, n, 5):
                    m.set_status(s, 5, None)
    assert isinstance(sp, pdi.drk.EllDrainState)
    assert torch.is_tensor(sp.status)
