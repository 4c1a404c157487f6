"""A small seeded burn in both packages: first under the escape-hatch
configuration (``ACCORD_TPU_FUSION=off``, ``ACCORD_TPU_DRAIN=fixpoint``,
``ACCORD_TPU_STORE_SHARD=off``; the reference on its single-device path),
then in the default configuration (fused multi-store flushes and ticks, the
adaptive drain wavefront): 3 nodes, chaos, churn and restarts on.  Both pass the strict-
serializability verifier and agree on every client-visible outcome and on
the committed history (``deps_found``, per-txn outcomes, the sim stats the
routes cannot move); two port runs of one seed are identical.

The port's stores are pinned to the device route, so its deps scans run
through the plain versions of its kernels on this CPU; the reference's
stores are pinned to the host route, which keeps the test off JAX's
compile time.  Every route answers with the same bytes, so the histories
must agree.  A burn's committed history does not depend on fusion, so the
default-configuration port run is held against the same host-routed
reference, with the fused-launch counters left out of the compared
stats."""

import pytest

ROUTE_STATS = ("DepsRoute.",)
# cost-model outcomes of the default configuration, on top of the routes
FUSED_STATS = ROUTE_STATS + ("DeviceDispatch.", "device_fused_")


@pytest.fixture(autouse=True)
def _slice_config(monkeypatch):
    monkeypatch.setenv("ACCORD_TPU_FUSION", "off")
    monkeypatch.setenv("ACCORD_TPU_DRAIN", "fixpoint")
    monkeypatch.setenv("ACCORD_TPU_STORE_SHARD", "off")
    import accord_tpu.parallel.sharded as sharded
    monkeypatch.setattr(sharded, "make_mesh", lambda d: None)
    from accord_tpu.local import device_index as rdi
    from accord_tpu_torch.local import device_index as pdi
    monkeypatch.setattr(rdi.DeviceState, "_choose_route",
                        lambda self, *a: "host")
    monkeypatch.setattr(pdi.DeviceState, "_choose_route",
                        lambda self, *a: "device")


def _record_results(monkeypatch, verifier_mod):
    """Every client result (op id, start, end, reads, appends) and every
    final list value the run's verifier sees, in arrival order."""
    log = []
    cls = verifier_mod.StrictSerializabilityVerifier
    on_result, set_final = cls.on_result, cls.set_final

    def rec_result(self, op_id, start, end, reads, appends):
        log.append(("result", op_id, start, end, sorted(reads.items()),
                    sorted(appends.items())))
        return on_result(self, op_id, start, end, reads, appends)

    def rec_final(self, token, value):
        log.append(("final", token, value))
        return set_final(self, token, value)

    monkeypatch.setattr(cls, "on_result", rec_result)
    monkeypatch.setattr(cls, "set_final", rec_final)
    return log


def _outcome(r, skip=ROUTE_STATS):
    stats = {k: v for k, v in r.stats.items() if not k.startswith(skip)}
    return ((r.ops_ok, r.ops_failed, r.ops_unresolved, r.epochs, r.restarts,
             r.evictions), stats)


def _burn(run_burn, **kw):
    return run_burn(5, n_ops=30, node_ids=(1, 2, 3), rf=3, shards=2, **kw)


def test_burn_matches_reference_and_is_deterministic(monkeypatch):
    from accord_tpu.sim import verifier as ref_verifier
    from accord_tpu.sim.burn import run_burn as ref_burn
    from accord_tpu_torch.sim import verifier as port_verifier
    from accord_tpu_torch.sim.burn import run_burn as port_burn
    ref_log = _record_results(monkeypatch, ref_verifier)
    port_log = _record_results(monkeypatch, port_verifier)
    ref = _burn(ref_burn)
    a = _burn(port_burn, device="cpu")
    a_log = list(port_log)
    b = _burn(port_burn, device="cpu")
    assert a.ops_unresolved == 0 and a.ops_ok > 0
    # per-txn client outcomes and final values, then the committed history
    assert a_log == ref_log and len(ref_log) > a.ops_ok
    assert port_log[len(a_log):] == a_log
    assert _outcome(a) == _outcome(ref)
    assert a.stats["deps_found"] == ref.stats["deps_found"] > 0
    assert a.stats == b.stats
    assert a.metrics_snapshot == b.metrics_snapshot
    assert a.span_export == b.span_export
    assert a.stats.get("DepsRoute.device", 0) > 0
    assert "DepsRoute.host" not in a.stats


def test_burn_default_config_matches_reference(monkeypatch):
    """Fusion and the log-depth wavefront on (their variables unset), the
    port's fused-vs-solo pricing forced to pay (a wall-clock calibrated
    model; this test holds the fused path, not the model): the same client
    log and committed history as the host-routed reference, and the fused
    flush and tick paths both ran."""
    monkeypatch.delenv("ACCORD_TPU_FUSION")
    monkeypatch.delenv("ACCORD_TPU_DRAIN")
    from accord_tpu.sim import verifier as ref_verifier
    from accord_tpu.sim.burn import run_burn as ref_burn
    from accord_tpu_torch.local.dispatch import (DeviceDispatcher,
                                                 fusion_enabled)
    from accord_tpu_torch.ops.drain_kernel import drain_logdepth_enabled
    from accord_tpu_torch.sim import verifier as port_verifier
    from accord_tpu_torch.sim.burn import run_burn as port_burn
    assert fusion_enabled() and drain_logdepth_enabled()
    monkeypatch.setattr(DeviceDispatcher, "_fused_flush_pays",
                        lambda self, hints: True)
    monkeypatch.setattr(DeviceDispatcher, "_fused_tick_pays",
                        lambda self, *a: True)
    ref_log = _record_results(monkeypatch, ref_verifier)
    port_log = _record_results(monkeypatch, port_verifier)
    ref = _burn(ref_burn)
    a = _burn(port_burn, device="cpu")
    assert a.ops_unresolved == 0 and a.ops_ok > 0
    assert port_log == ref_log and len(ref_log) > a.ops_ok
    assert _outcome(a, FUSED_STATS) == _outcome(ref, FUSED_STATS)
    assert a.stats["deps_found"] == ref.stats["deps_found"] > 0
    assert a.stats["device_fused_launches"] > 0
    assert a.stats["device_fused_tick_launches"] > 0
    assert "DepsRoute.host" not in a.stats


@pytest.mark.parametrize("default_config", [False, True])
def test_burn_on_mesh_matches_reference(monkeypatch, default_config):
    """The port's stores on an 8-slice CPU mesh (every device-route scan
    a sharded one, the drain tick row-sharded where priced so), against
    the reference's burn with its conftest mesh in place: the same client
    log and committed history.  Under the escape hatches, then in the
    default configuration with the fused pricing forced to pay (the
    fused flush under a mesh: per slice one K5 launch over the members,
    the blocks merged on device)."""
    import accord_tpu.parallel.sharded as rsh
    from accord_tpu.sim import verifier as ref_verifier
    from accord_tpu.sim.burn import run_burn as ref_burn
    from accord_tpu_torch.local.dispatch import DeviceDispatcher
    from accord_tpu_torch.parallel import make_mesh
    from accord_tpu_torch.sim import verifier as port_verifier
    from accord_tpu_torch.sim.burn import run_burn as port_burn
    monkeypatch.undo()
    if not default_config:
        monkeypatch.setenv("ACCORD_TPU_FUSION", "off")
        monkeypatch.setenv("ACCORD_TPU_DRAIN", "fixpoint")
    else:
        monkeypatch.delenv("ACCORD_TPU_FUSION", raising=False)
        monkeypatch.delenv("ACCORD_TPU_DRAIN", raising=False)
        monkeypatch.setattr(DeviceDispatcher, "_fused_flush_pays",
                            lambda self, hints: True)
    from accord_tpu.local import device_index as rdi
    from accord_tpu_torch.local import device_index as pdi
    monkeypatch.setattr(rdi.DeviceState, "_choose_route",
                        lambda self, *a: "host")
    monkeypatch.setattr(pdi.DeviceState, "_choose_route",
                        lambda self, *a: "device")
    assert rsh.make_mesh(8) is not None
    ref_log = _record_results(monkeypatch, ref_verifier)
    port_log = _record_results(monkeypatch, port_verifier)
    ref = _burn(ref_burn)
    a = _burn(port_burn, device="cpu", mesh=make_mesh(8, "cpu"))
    skip = FUSED_STATS if default_config else ROUTE_STATS
    assert a.ops_unresolved == 0 and a.ops_ok > 0
    assert port_log == ref_log and len(ref_log) > a.ops_ok
    assert _outcome(a, skip) == _outcome(ref, skip)
    assert a.stats["deps_found"] == ref.stats["deps_found"] > 0
    assert a.stats.get("DepsRoute.device", 0) > 0
    mesh_q = sum(v for k, v in a.metrics_snapshot.items()
                 if k.startswith("device_mesh_queries{"))
    assert mesh_q > 0
    if default_config:
        assert a.stats["device_fused_launches"] > 0
