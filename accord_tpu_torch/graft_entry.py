"""Entry points of the port, the twins of the repository's
``__graft_entry__.py``.

- ``entry(device=None)``: (fn, args) — one protocol step on one device:
  the bucketed deps scan (K1a, CSR out), the dense scan with each query's
  max-conflict (K11), the dense fixpoint drain (K8 dense) and the ELL
  fixpoint drain (K8 ELL).
- ``dryrun_multichip(n, device=None)``: the sharded protocol step over an
  n-slice mesh, held against the single-device kernels, then the live sim
  cluster, the row-sharded frontier and the mesh bucketed / pruned routes,
  as the reference's dryrun does.

Both run on the card unless ``device`` asks for the CPU.  The mesh's n
slices share ``device`` (default ``cuda``, one card), so the run is the
same on any machine.
"""

import numpy as np
import torch


def _graft_store():
    """Minimal store surface DeviceState attribution touches."""
    from .local.redundant import RedundantBefore

    class _Store:
        def __init__(self):
            self.commands_for_key = {}
            self.redundant_before = RedundantBefore()

        class node:
            scheduler = None

    return _Store()


def _example_inputs(capacity, batch, device, max_intervals=4):
    from .ops import deps_kernel as dk
    from .ops import drain_kernel as drk
    from .ops.packing import pack_timestamps
    from .primitives.keys import Range
    from .primitives.timestamp import Domain, TxnId, TxnKind

    entries = []
    for i in range(capacity):
        kind = TxnKind.Write if i % 3 else TxnKind.Read
        tid = TxnId.create(1, 100 + i, kind, Domain.Key, 1 + i % 3)
        status = [dk.SLOT_PREACCEPTED, dk.SLOT_COMMITTED, dk.SLOT_STABLE,
                  dk.SLOT_APPLIED][i % 4]
        toks = [(i * 7) % 50, (i * 13) % 50]
        rngs = [Range(i % 40, i % 40 + 3)] if i % 5 == 0 else []
        entries.append((tid, status, toks, rngs))
    table = dk.build_table(entries, capacity=capacity,
                           max_intervals=max_intervals, device=device)

    queries = []
    for b in range(batch):
        bound = TxnId.create(1, 500 + b, TxnKind.Write, Domain.Key, 1)
        queries.append((bound, bound.kind().witnesses(), [(b * 11) % 50], []))
    query = dk.build_query(queries, max_intervals=max_intervals,
                           device=device)

    rng = np.random.default_rng(0)
    adj = rng.random((capacity, capacity)) < 0.05
    np.fill_diagonal(adj, False)
    exec_ts = [TxnId.create(1, 100 + i, TxnKind.Write, Domain.Key, 1)
               for i in range(capacity)]
    em, el, en = pack_timestamps(exec_ts)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state = drk.DrainState(up(adj), table.status.clone(), up(em), up(el),
                           up(en), torch.zeros(capacity, dtype=torch.bool,
                                               device=device))
    return table, query, state


def entry(device=None):
    """Returns (fn, example_args): one protocol step on one device — the
    bucketed-index deps scan (CSR out) + the dense scan with max-conflict
    + the dense fixpoint drain + the sparse ELL fixpoint drain."""
    from .local.commands_for_key import InternalStatus
    from .local.device_index import DeviceState
    from .ops import deps_kernel as dk
    from .ops import drain_kernel as drk
    from .ops.packing import pack_timestamps
    from .primitives.keys import IntKey, Keys, Range, Ranges
    from .primitives.timestamp import Domain, TxnId, TxnKind

    device = torch.device(device or "cuda")
    dev = DeviceState(_graft_store(), device=device, mesh=None)
    for i in range(48):
        kind = TxnKind.Write if i % 3 else TxnKind.Read
        tid = TxnId.create(1, 100 + i, kind, Domain.Key, 1 + i % 3)
        if i % 5 == 0:
            keys = Ranges.of(Range(i % 40, i % 40 + 3))
        else:
            keys = Keys([IntKey((i * 7) % 50), IntKey((i * 13) % 50)])
        dev.register(tid, int(InternalStatus.PREACCEPTED), keys)
    table_b = dev.deps.device_table()
    btable = dev.deps.bucket_device()
    m, span = 4, dev.deps.SPAN
    packed = []
    for b in range(8):
        bound = TxnId.create(1, 500 + b, TxnKind.Write, Domain.Key, 1)
        packed.append((bound, bound.kind().witnesses(), [(b * 11) % 50],
                       [], bound))
    qnp = dk.pack_query_matrix(packed, m)
    qcols, _wide = dev._bucket_query_cols(qnp, m)
    qmat = torch.from_numpy(np.concatenate(
        [qnp, qcols.reshape(len(packed), m * span)], axis=1)).to(device)
    s_cap, k_cap = 512, 64

    # ELL drain example: 64 slots, short chains
    ids = [TxnId.create(1, 10 + i, TxnKind.Write, Domain.Key, 1)
           for i in range(64)]
    em, el, en = pack_timestamps(ids)
    adj_idx = np.full((64, 4), -1, np.int32)
    for i in range(1, 64):
        adj_idx[i, 0] = i - 1

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ell = drk.EllDrainState(up(adj_idx),
                            torch.full((64,), dk.SLOT_STABLE,
                                       dtype=torch.int32, device=device),
                            up(em), up(el), up(en),
                            torch.zeros(64, dtype=torch.bool, device=device))

    def protocol_step(table, btable, qmat, query, state, ell):
        csr = dk.bucketed_flat(table, btable, qmat, m, span, s_cap, k_cap)
        dep_mask, max_conflict = dk.calculate_deps(table, query)
        applied, newly = drk.drain(state)
        a2, n2 = drk.drain_ell(ell)
        return csr, dep_mask, max_conflict, applied, newly, a2, n2

    table, query, state = _example_inputs(64, 8, device)
    return protocol_step, (table_b, btable, qmat, query, state, ell)


def _eq(a, b, what: str) -> None:
    """Byte equality of two results (tensors, arrays, or nested tuples
    of them)."""
    if isinstance(a, (tuple, list)) and not np.isscalar(a):
        if len(a) != len(b):
            raise AssertionError(f"dryrun_multichip: {what} differs")
        for x, y in zip(a, b):
            _eq(x, y, what)
        return
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"dryrun_multichip: {what} differs")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The sharded protocol step over an n-slice mesh (all on ``device``,
    default ``cuda``), held byte for byte against the single-device
    kernels; then the live protocol slice over the mesh, the row-sharded
    frontier on live stores and the mesh bucketed + pruned routes."""
    from .ops import deps_kernel as dk
    from .ops import drain_kernel as drk
    from .parallel import make_mesh, shard_table, sharded_protocol_step

    device = torch.device(device or "cuda")
    capacity = 8 * n_devices
    mesh = make_mesh(n_devices, device)
    table, query, state = _example_inputs(capacity, 4, device)
    sharded = shard_table(mesh, table)
    step = sharded_protocol_step(mesh)
    dep_mask, max_conflict, applied, newly = step(sharded, query, state)
    dep_mask = torch.cat([x.to(device) for x in dep_mask], dim=1)
    assert tuple(dep_mask.shape) == (4, capacity)
    assert tuple(applied.shape) == (capacity,)
    ref_mask, (rm, rl, rn) = dk.calculate_deps(table, query)
    ref_applied, ref_newly = drk.drain(state)
    gm, gl, gn = max_conflict
    _eq(dep_mask, ref_mask, "dep mask")
    _eq(gm, rm, "max-conflict msb")
    _eq(gl, rl, "max-conflict lsb")
    _eq(gn, rn, "max-conflict node")
    _eq(applied, ref_applied, "applied")
    _eq(newly, ref_newly, "newly")

    # the LIVE protocol slice over the mesh: a multi-node sim cluster in
    # device mode whose stores shard their deps tables across the mesh
    from .sim.cluster import Cluster
    from .sim.kvstore import KVDataStore, kv_txn
    from .sim.topology_factory import build_topology
    cluster = Cluster(topology=build_topology(1, (1, 2, 3), 3, 4), seed=7,
                      data_store_factory=KVDataStore, device_mode=True,
                      device=device, mesh=mesh)
    # pin the device route: the adaptive router may serve tiny sim scans
    # from the host tail, and this dryrun exists to prove the MESH path
    for node in cluster.nodes.values():
        for s in node.command_stores.stores:
            s.device.route_override = "device"
    out = []
    for i in range(6):
        cluster.nodes[1 + (i % 3)].coordinate(
            kv_txn([i * 10, (i + 1) * 10], {i * 10: (f"v{i}",)})).begin(
            lambda r, f: out.append((r, f)))
        cluster.run_until_quiescent()
    assert all(f is None for _r, f in out), out
    mesh_q = sum(s.device.n_mesh_queries
                 for node in cluster.nodes.values()
                 for s in node.command_stores.stores)
    assert mesh_q > 0, "protocol slice never used the mesh-sharded scan"
    # the live drain path under the mesh: the row-sharded frontier sweep
    # must agree with the single-device kernel on a live store's state
    from .parallel.sharded import sharded_ready_frontier
    for node in cluster.nodes.values():
        for s in node.command_stores.stores:
            st, live = s.device.drain.state()
            if isinstance(st, drk.DrainState) and len(live) and \
                    st.status.shape[0] % n_devices == 0:
                _eq(sharded_ready_frontier(mesh)(st),
                    drk.ready_frontier(st), "live frontier")
    # reads see every committed write
    check = []
    cluster.nodes[1].coordinate(kv_txn([0], {})).begin(
        lambda r, f: check.append((r, f)))
    cluster.run_until_quiescent()
    assert check[0][1] is None and check[0][0].reads[0] == ("v0",)

    # the mesh bucketed + pruned kernels: the row-sharded bucket index and
    # the device-side floor prune must agree with the single-device route
    # through the live dispatch stack
    from .local.commands_for_key import InternalStatus
    from .local.device_index import DeviceState
    from .primitives.keys import IntKey, Keys, Range, Ranges
    from .primitives.timestamp import Domain, TxnId, TxnKind

    store = _graft_store()
    dev = DeviceState(store, device=device, mesh=mesh)
    assert dev.mesh is not None
    rng = np.random.default_rng(3)
    hlcs = rng.choice(np.arange(1, 40_000), size=200, replace=False)
    for i in range(200):
        tid = TxnId.create(1, int(hlcs[i]), TxnKind.Write, Domain.Key,
                           1 + i % 3)
        toks = [int(t) for t in rng.integers(0, 2_000, 2)]
        dev.register(tid, int(InternalStatus.PREACCEPTED),
                     Keys([IntKey(t) for t in toks]))
    floor = TxnId.create(1, 10_000, TxnKind.ExclusiveSyncPoint,
                         Domain.Range, 1)
    store.redundant_before.add_redundant(
        Ranges.of(Range(-(1 << 60), 1 << 60)), floor)
    qs = []
    for _ in range(16):
        bound = TxnId.create(1, int(rng.integers(50_000, 60_000)),
                             TxnKind.Write, Domain.Key, 1)
        toks = [int(t) for t in rng.integers(0, 2_000, 2)]
        qs.append((bound, bound, bound.kind().witnesses(), toks, []))

    def run(route, mesh_on):
        dev.route_override = route
        saved = dev.mesh
        dev.mesh = dev.mesh if mesh_on else None
        try:
            return dev.deps_query_batch_end(dev.deps_query_batch_begin(
                qs, immediate=True, prune_floors=True))
        finally:
            dev.mesh = saved

    single = run("device", mesh_on=False)
    sharded_out = run("device", mesh_on=True)
    assert dev.n_mesh_bucketed_queries > 0, \
        "the sharded bucketed kernel never ran"
    for i, (a, b) in enumerate(zip(single, sharded_out)):
        _eq(a, b, f"mesh bucketed result {i}")
