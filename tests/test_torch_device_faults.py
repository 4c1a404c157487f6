"""Real CUDA errors on the port's device fault ladder, on the CPU.

The reference puts jaxlib's ``XlaRuntimeError`` in ``DEVICE_EXCEPTIONS``
(``accord_tpu/utils/faults.py``): a refused launch or a device OOM
quarantines the device and the flush answers from the host route with the
same bytes.  The port's counterparts are ``faults.CudaLaunchError`` (what
``ops.kernels._launch`` raises for a launch refused for want of resources)
and ``torch.OutOfMemoryError`` (from a wrapper's ``torch.empty``).  Here a
kernel wrapper is replaced by one that raises them, on the bucketed, dense
and attributed routes, in the dirty-row scatter, in a fused flush and in a
drain tick; each must quarantine, fail the whole flush or tick over to the
host and give what the reference gives fault-free on the same seed (its
host route, so that no test here waits on a JAX compile: every route of
the reference gives the same bytes, ``tests/test_torch_device_state.py``).  An
error that shows only at synchronisation (``torch.AcceleratorError`` from
the download) poisons the CUDA context and must propagate, and so must a
return code that says the library or its wrapper is at fault (an invalid
argument, no image for the card): no host route may hide those."""

import pytest
import torch

import accord_tpu
import accord_tpu_torch
from accord_tpu_torch.local import device_index as pdi
from accord_tpu_torch.ops import kernels
from accord_tpu_torch.utils import faults
from tests.test_torch_device_state import _attributed, _build

REAL_ERRORS = {
    "launch": lambda: kernels.launch_error(
        "deps_bucketed", 720, "too many blocks in cooperative launch"),
    "oom": lambda: torch.OutOfMemoryError("CUDA out of memory"),
}


@pytest.fixture(autouse=True)
def _slice_config(monkeypatch):
    monkeypatch.setenv("ACCORD_TPU_FUSION", "off")
    monkeypatch.setenv("ACCORD_TPU_DRAIN", "fixpoint")
    monkeypatch.setenv("ACCORD_TPU_STORE_SHARD", "off")


def _fail_once(monkeypatch, name, error):
    """Replace kernel wrapper ``name`` by one whose first call raises."""
    real = getattr(kernels, name)
    calls = []

    def wrapper(*a, **kw):
        calls.append(name)
        if len(calls) == 1:
            raise error()
        return real(*a, **kw)
    monkeypatch.setattr(kernels, name, wrapper)
    return calls


def test_return_codes_map_to_the_ladder():
    """A launch refused for want of resources is a CudaLaunchError on the
    ladder; every other code (a sticky one: the context is lost; an
    invalid argument or no image for the card: a build or wrapper fault)
    is a plain RuntimeError that propagates."""
    for rc in (2, 701, 720):
        e = kernels.launch_error("merge_blocks", rc, "refused")
        assert isinstance(e, faults.CudaLaunchError) and e.code == rc
        assert isinstance(e, faults.DEVICE_EXCEPTIONS)
        assert "merge_blocks" in str(e) and f"error {rc}" in str(e)
    for rc in (1, 98, 200, 209, 218, 222, 700, 702, 710, 714, 715, 716,
               717, 718, 719):
        e = kernels.launch_error("scatter_rows", rc, "not a refusal")
        assert type(e) is RuntimeError and f"error {rc}" in str(e)
        assert not isinstance(e, faults.DEVICE_EXCEPTIONS)
    assert issubclass(torch.OutOfMemoryError, faults.DEVICE_EXCEPTIONS)
    assert not issubclass(torch.AcceleratorError, faults.DEVICE_EXCEPTIONS)
    assert faults.kind_of(faults.CudaLaunchError("x")) == "device_error"


@pytest.mark.parametrize("rc", [1, 98, 209])
def test_build_and_wrapper_faults_propagate(monkeypatch, rc):
    """A return code that blames the library or its wrapper (an invalid
    argument, an invalid device function, no image for the card) is not
    failed over: the flush raises it, nothing quarantines, and no query
    is answered from the host."""
    port, psafe, pqs, _ = _build(accord_tpu_torch, 3, n=120, nq=12)
    port.route_override = "device"
    _fail_once(monkeypatch, "deps_bucketed",
               lambda: kernels.launch_error("deps_bucketed", rc, "refused"))
    with pytest.raises(RuntimeError, match=f"error {rc}"):
        _attributed(accord_tpu_torch, port, psafe, pqs, True)
    assert port.n_device_faults == 0 and port.n_quarantines == 0
    assert port.n_fallback_queries == 0


@pytest.mark.parametrize("error", sorted(REAL_ERRORS))
@pytest.mark.parametrize("route,wrapper", [("device", "deps_bucketed"),
                                           ("dense", "deps_dense"),
                                           ("device", "attr_post"),
                                           ("device", "scatter_rows")])
def test_flush_fails_over_with_reference_bytes(monkeypatch, route, wrapper,
                                               error):
    ref, rsafe, rqs, rreg = _build(accord_tpu, 3, n=120, nq=12)
    port, psafe, pqs, preg = _build(accord_tpu_torch, 3, n=120, nq=12)
    ref.route_override, port.route_override = "host", route
    if wrapper == "scatter_rows":
        # the table is on the card; new registrations make dirty rows
        _attributed(accord_tpu_torch, port, psafe, pqs[:2], True)
        preg(6, 10_000, 10_500)
        rreg(6, 10_000, 10_500)
    want = _attributed(accord_tpu, ref, rsafe, rqs, True)
    calls = _fail_once(monkeypatch, wrapper, REAL_ERRORS[error])
    got = _attributed(accord_tpu_torch, port, psafe, pqs, True)
    assert calls and got == want
    assert sum(len(k) + len(r) for k, r in want) > 0
    assert port.n_device_faults == 1 and port.n_quarantines == 1
    assert port.n_fallback_queries == len(pqs)
    assert port._dev_quar_flushes > 0 and not port.deps._leases


def test_quarantine_probes_and_restores_after_a_refused_launch(
        monkeypatch):
    """After the failover the store sits out its backoff on the host
    route, then a probe flush on the device restores it; every flush
    gives the reference's bytes."""
    ref, rsafe, rqs, _ = _build(accord_tpu, 4, n=120, nq=12)
    port, psafe, pqs, _ = _build(accord_tpu_torch, 4, n=120, nq=12)
    ref.route_override, port.route_override = "host", "device"
    want = _attributed(accord_tpu, ref, rsafe, rqs, True)
    _fail_once(monkeypatch, "deps_bucketed", REAL_ERRORS["launch"])
    for _ in range(16):
        assert _attributed(accord_tpu_torch, port, psafe, pqs, True) == want
        if port.n_restores:
            break
    assert port.n_device_faults == 1 and port.n_quarantines == 1
    assert port.n_restores == 1 and port._dev_quar_flushes == 0


@pytest.mark.parametrize("error", sorted(REAL_ERRORS))
def test_fused_flush_fails_every_member_over(monkeypatch, error):
    """A refused fused launch fails the whole batch over: every member
    quarantines and builds the Deps of the fault-free fused run."""
    monkeypatch.delenv("ACCORD_TPU_FUSION")
    import chip_smoke as cs
    cs.P.load()
    monkeypatch.setattr(cs.P.DeviceDispatcher, "_fused_flush_pays",
                        lambda self, hints: True)
    node, devs = cs.launch_harness(3, 32, 48, True, "cpu")
    want = [cs.deps_digest(b)
            for b in cs.drive_flushes(node, devs, 1, 48, seed=7)]
    node, devs = cs.launch_harness(3, 32, 48, True, "cpu")
    calls = _fail_once(monkeypatch, "fused_deps_dense", REAL_ERRORS[error])
    got = [cs.deps_digest(b)
           for b in cs.drive_flushes(node, devs, 1, 48, seed=7)]
    assert calls and got == want
    assert node.dispatcher.n_fused_launches == 0
    assert all(d.n_device_faults == 1 and d._dev_quar_flushes > 0
               for d in devs)


def _chain_tick(pkg, dev, fail=None, monkeypatch=None):
    """One drain tick over a 6-deep chain: the txns it proposed."""
    from importlib import import_module
    from tests.test_torch_dispatch import _RecordingSafe, _chain
    ts = import_module(pkg.__name__ + ".primitives.timestamp")
    _chain(dev, ts)
    if fail:
        _fail_once(monkeypatch, "frontier_dense", REAL_ERRORS[fail])
    safe = _RecordingSafe(dev.store)
    dev._tick(safe)
    return safe.asked


@pytest.mark.parametrize("error", sorted(REAL_ERRORS))
def test_drain_tick_fails_over_with_reference_candidates(monkeypatch,
                                                         error):
    import chip_smoke as cs
    from tests.conftest import make_device_state
    cs.P.load()
    _rs, ref, _rsafe = make_device_state(mesh=None)
    want = _chain_tick(accord_tpu, ref)
    assert len(want) == 1
    port = cs.P.DeviceState(cs.Store(), device="cpu")
    got = _chain_tick(accord_tpu_torch, port, error, monkeypatch)
    assert got == want
    assert port.n_host_ticks == 1 and port.n_device_ticks == 0
    assert port.n_device_faults == 1 and port.n_quarantines == 1


def test_errors_at_synchronisation_propagate(monkeypatch):
    """An error the download's synchronisation reports (an illegal
    address in a kernel that ran) is not failed over: the flush and the
    drain tick raise it."""
    import chip_smoke as cs

    def sticky(_t):
        raise torch.AcceleratorError(
            "CUDA error: an illegal memory access was encountered")
    port, psafe, pqs, _ = _build(accord_tpu_torch, 3, n=120, nq=12)
    port.route_override = "device"
    monkeypatch.setattr(pdi, "_host", sticky)
    with pytest.raises(torch.AcceleratorError):
        _attributed(accord_tpu_torch, port, psafe, pqs, True)
    assert port.n_device_faults == 0 and port.n_quarantines == 0
    cs.P.load()
    dev = cs.P.DeviceState(cs.Store(), device="cpu")
    with pytest.raises(torch.AcceleratorError):
        _chain_tick(accord_tpu_torch, dev)
    assert dev.n_device_faults == 0 and dev.n_host_ticks == 0
