"""Fault injection: protocol flags + injectable accelerator faults.

Rebuild of ref: accord-core/src/main/java/accord/utils/Faults.java:22-28 —
compile-time-style switches that deliberately weaken a protocol guarantee so
the verification harness can prove it would catch the resulting violation —
extended with a registry of injectable DEVICE-BOUNDARY faults, the
accelerator-side analogue of the sim's network nemesis (drops / partitions /
crash-restarts): kernel-launch failure, transfer/upload failure, simulated
HBM OOM on capacity grow, and stale/corrupted kernel results.

Two shapes of switch:

- **Boolean flags** (``TRANSACTION_INSTABILITY``, ``PARANOIA``): module
  attributes, flipped by tests via ``with faults.enabled("NAME"):`` instead
  of hand-rolled try/finally.
- **Device faults**: armed per-kind with a probability and a seedable
  ``RandomSource`` (``inject_device_fault`` / the ``device_fault`` context
  manager).  Every device-boundary operation asks ``should_fire(kind)`` /
  ``check(kind)``; the draw comes from the injected source only, so a
  same-seed chaos run stays bit-reproducible and the fault stream never
  perturbs the cluster's protocol randomness.

The consumer of the fault surface is the degradation ladder in
local/device_index.py (route quarantine -> host fallback -> compaction ->
backpressure); all defaults are off — a production process never draws.

Real CUDA errors take the same ladder when they are refusals of resources
the process survives, as the reference treats jaxlib's ``XlaRuntimeError``
at run time: a launch the runtime refuses for want of resources
(``CudaLaunchError``, raised by ``ops.kernels._launch`` for the return
codes of memory allocation, out of resources and a cooperative grid over
the resident limit) and device memory exhausted (``torch.OutOfMemoryError``,
from a wrapper's ``torch.empty`` or a copy) quarantine the device and fail
the flush over to the host route, with the same bytes.  Every other return
code propagates as a plain ``RuntimeError``: an invalid argument or a
library with no image for this card is a fault of the build or of a
wrapper, which no host route may hide.  An error that only shows at
synchronisation (a fault during a kernel's run: an illegal address, a
device-side assert) poisons the CUDA context, so no fail-over inside the
process can survive it: it is not in ``DEVICE_EXCEPTIONS`` and propagates
(``torch.AcceleratorError`` from the download that synchronises, or
``RuntimeError`` from ``_launch`` when a later launch returns such a sticky
code).

Fused launches (r08, local/dispatch.py) are a SINGLE fault domain: one
``kernel_launch`` draw covers the whole fused dispatch and one ``transfer``
draw covers the shared result download, so a fault inside a fused launch
fails EVERY member store's flush/tick over to the host route together —
then each member quarantines and re-probes independently, exactly as solo
faults do.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, Iterator, Optional, Tuple

import torch

from .random_source import RandomSource

# Skip ensuring stability (deps durable at a quorum) before execution
# (ref: Faults.TRANSACTION_INSTABILITY consumed at CoordinationAdapter.java:173)
TRANSACTION_INSTABILITY = False

# Paranoia mode: every device-route deps flush is shadow-verified against
# the always-correct host route; any mismatch quarantines the device route
# (the ONLY detector for the stale_result fault class, which corrupts
# silently).  Costs one host scan per device flush — chaos/verification
# runs only.
PARANOIA = False


class DeviceFaultError(RuntimeError):
    """Base of every injected device-boundary failure."""


class KernelLaunchFault(DeviceFaultError):
    """A kernel dispatch failed to launch (injected XlaRuntimeError-alike)."""


class TransferFault(DeviceFaultError):
    """A host<->device transfer (upload or result download) failed."""


class HbmOomFault(DeviceFaultError):
    """Device memory exhausted while growing a device-resident buffer."""


class StaleResultFault(DeviceFaultError):
    """A kernel returned stale/corrupted bytes (detected by shadow-verify)."""


DEVICE_FAULT_KINDS: Dict[str, type] = {
    "kernel_launch": KernelLaunchFault,
    "transfer": TransferFault,
    "hbm_oom": HbmOomFault,
    "stale_result": StaleResultFault,
}

class CudaLaunchError(RuntimeError):
    """The CUDA runtime refused a kernel launch for want of resources (a
    kernel library entry point returned cudaErrorMemoryAllocation,
    cudaErrorLaunchOutOfResources or cudaErrorCooperativeLaunchTooLarge);
    ``code`` is the cudaError_t."""

    def __init__(self, message: str, code: int = 0):
        super().__init__(message)
        self.code = code


# exception types the device layer treats as a device-boundary failure (and
# therefore quarantines + fails over on) — injected faults plus the real
# runtime's launches refused for want of resources and device OOM, as the
# reference adds XlaRuntimeError.  Kernel-build errors, invalid arguments
# and sticky CUDA errors (those that poison the context, seen at
# synchronisation) are NOT here: they propagate
DEVICE_EXCEPTIONS: Tuple[type, ...] = (DeviceFaultError, MemoryError,
                                       CudaLaunchError,
                                       torch.OutOfMemoryError)

# kind -> (probability, RandomSource); empty means no draws anywhere
_armed: Dict[str, Tuple[float, RandomSource]] = {}


def inject_device_fault(kind: str, probability: float,
                        random: RandomSource) -> None:
    """Arm one fault class.  Draws come from ``random`` ONLY (pass a fork of
    the run's seeded source so same-seed runs replay the same faults)."""
    if kind not in DEVICE_FAULT_KINDS:
        raise ValueError(f"unknown device fault kind {kind!r}; "
                         f"one of {sorted(DEVICE_FAULT_KINDS)}")
    _armed[kind] = (probability, random)


def clear_device_faults(kind: Optional[str] = None) -> None:
    if kind is None:
        _armed.clear()
    else:
        _armed.pop(kind, None)


def active_device_faults() -> Dict[str, float]:
    return {k: p for k, (p, _r) in _armed.items()}


def should_fire(kind: str) -> bool:
    """One deterministic draw against ``kind``'s armed probability (no draw —
    and False — when the kind is not armed)."""
    armed = _armed.get(kind)
    if armed is None:
        return False
    probability, random = armed
    return random.decide(probability)


def check(kind: str, detail: str = "") -> None:
    """Raise the kind's fault exception if the armed fault fires."""
    if should_fire(kind):
        raise DEVICE_FAULT_KINDS[kind](f"injected {kind} fault: {detail}")


def kind_of(exc: BaseException) -> str:
    """Classify a device-boundary exception for counters/trace events."""
    for kind, cls in DEVICE_FAULT_KINDS.items():
        if isinstance(exc, cls):
            return kind
    return "device_error"


@contextlib.contextmanager
def device_fault(kind: str, probability: float,
                 random: RandomSource) -> Iterator[None]:
    """Arm ``kind`` for the block, restoring the prior arming on exit."""
    prior = _armed.get(kind)
    inject_device_fault(kind, probability, random)
    try:
        yield
    finally:
        if prior is None:
            _armed.pop(kind, None)
        else:
            _armed[kind] = prior


# ---------------------------------------------------------------------------
# socket faults (r12): the network-boundary analogue of the device faults —
# seedable, drawn ONLY from the injected RandomSource, armed per-process
# (the serving nodes are separate OS processes, so arming crosses the exec
# boundary via the ACCORD_TPU_NET_FAULTS env var).
# ---------------------------------------------------------------------------

class SocketFaultError(RuntimeError):
    """Base of every injected network-boundary failure."""


class ConnResetFault(SocketFaultError):
    """The connection is torn down abruptly mid-frame (RST-alike); the
    frame is lost and the peer link must reconnect through its backoff."""


class StalledPeerFault(SocketFaultError):
    """The peer stops draining for a drawn interval (wedged process /
    full socket buffer): writes stall, timeouts own the recovery."""


class SlowLinkFault(SocketFaultError):
    """Per-frame added latency (congested / lossy path)."""


SOCKET_FAULT_KINDS: Dict[str, type] = {
    "conn_reset": ConnResetFault,
    "stalled_peer": StalledPeerFault,
    "slow_link": SlowLinkFault,
}

# drawn stall/delay bounds per kind (micros) — the duration draw comes from
# the SAME armed RandomSource as the fire decision, so a seeded run replays
# the exact fault timeline
_SOCKET_DELAY_BOUNDS = {
    "slow_link": (5_000, 60_000),
    "stalled_peer": (100_000, 600_000),
}

NET_FAULTS_ENV = "ACCORD_TPU_NET_FAULTS"

# kind -> (probability, RandomSource); empty means no draws anywhere
_socket_armed: Dict[str, Tuple[float, RandomSource]] = {}


def inject_socket_fault(kind: str, probability: float,
                        random: RandomSource) -> None:
    """Arm one socket fault class (draws come from ``random`` ONLY)."""
    if kind not in SOCKET_FAULT_KINDS:
        raise ValueError(f"unknown socket fault kind {kind!r}; "
                         f"one of {sorted(SOCKET_FAULT_KINDS)}")
    _socket_armed[kind] = (probability, random)


def clear_socket_faults(kind: Optional[str] = None) -> None:
    if kind is None:
        _socket_armed.clear()
    else:
        _socket_armed.pop(kind, None)


def active_socket_faults() -> Dict[str, float]:
    return {k: p for k, (p, _r) in _socket_armed.items()}


def socket_fault_fires(kind: str) -> bool:
    """One deterministic draw against ``kind``'s armed probability (no
    draw — and False — when unarmed)."""
    armed = _socket_armed.get(kind)
    if armed is None:
        return False
    probability, random = armed
    return random.decide(probability)


def socket_fault_delay_micros(kind: str) -> int:
    """Drawn duration for a fired slow_link/stalled_peer fault."""
    armed = _socket_armed.get(kind)
    lo, hi = _SOCKET_DELAY_BOUNDS.get(kind, (1_000, 10_000))
    if armed is None:
        return lo
    _p, random = armed
    return lo + random.next_int(hi - lo)


def arm_socket_faults_from_env(spec: Optional[str] = None) -> Dict[str, float]:
    """Parse ``kind:probability:seed[,kind:probability:seed...]`` (the
    ACCORD_TPU_NET_FAULTS format the serving harness passes to spawned
    node processes) and arm each class.  Returns {kind: probability};
    empty/unset spec arms nothing."""
    import os
    if spec is None:
        spec = os.environ.get(NET_FAULTS_ENV, "")
    armed = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        kind, prob, seed = part.split(":")
        inject_socket_fault(kind, float(prob), RandomSource(int(seed)))
        armed[kind] = float(prob)
    return armed


@contextlib.contextmanager
def socket_fault(kind: str, probability: float,
                 random: RandomSource) -> Iterator[None]:
    """Arm ``kind`` for the block, restoring the prior arming on exit."""
    prior = _socket_armed.get(kind)
    inject_socket_fault(kind, probability, random)
    try:
        yield
    finally:
        if prior is None:
            _socket_armed.pop(kind, None)
        else:
            _socket_armed[kind] = prior


# ---------------------------------------------------------------------------
# disk faults (r13): the storage-boundary analogue of the device and socket
# faults — seedable, drawn ONLY from the injected RandomSource, consulted by
# the durable journal (accord_tpu.journal) at every write/fsync/read
# boundary.  Armed cross-process via ACCORD_TPU_DISK_FAULTS (same
# kind:prob:seed format as the socket faults).
# ---------------------------------------------------------------------------

class DiskFaultError(OSError):
    """Base of every injected storage-boundary failure (an OSError: the
    journal must treat an injected fault exactly like the real thing)."""


class TornWriteFault(DiskFaultError):
    """A write persisted only a drawn prefix before the process died
    (page-cache loss / power cut mid-sector).  The journal's CRC framing
    must detect the torn tail on reopen and truncate, never mis-replay."""


class ShortReadFault(DiskFaultError):
    """A read returned fewer bytes than asked (transient I/O error).
    Recovery must treat it as an unreadable tail, not crash or loop."""


class FailedFsyncFault(DiskFaultError):
    """fsync itself failed (the postgres lesson: the page cache may have
    DROPPED the dirty pages — retrying is not safe).  The group commit
    must degrade loudly: stop promising durability, keep serving."""


DISK_FAULT_KINDS: Dict[str, type] = {
    "torn_write": TornWriteFault,
    "short_read": ShortReadFault,
    "failed_fsync": FailedFsyncFault,
}

DISK_FAULTS_ENV = "ACCORD_TPU_DISK_FAULTS"

# kind -> (probability, RandomSource); empty means no draws anywhere
_disk_armed: Dict[str, Tuple[float, RandomSource]] = {}


def inject_disk_fault(kind: str, probability: float,
                      random: RandomSource) -> None:
    """Arm one disk fault class (draws come from ``random`` ONLY)."""
    if kind not in DISK_FAULT_KINDS:
        raise ValueError(f"unknown disk fault kind {kind!r}; "
                         f"one of {sorted(DISK_FAULT_KINDS)}")
    _disk_armed[kind] = (probability, random)


def clear_disk_faults(kind: Optional[str] = None) -> None:
    if kind is None:
        _disk_armed.clear()
    else:
        _disk_armed.pop(kind, None)


def active_disk_faults() -> Dict[str, float]:
    return {k: p for k, (p, _r) in _disk_armed.items()}


def disk_fault_fires(kind: str) -> bool:
    """One deterministic draw against ``kind``'s armed probability (no
    draw — and False — when unarmed)."""
    armed = _disk_armed.get(kind)
    if armed is None:
        return False
    probability, random = armed
    return random.decide(probability)


def disk_fault_fraction(kind: str) -> float:
    """Drawn cut point for a fired torn_write/short_read: the fraction of
    the buffer that actually persisted / was returned.  Same armed source
    as the fire decision, so a seeded run replays the exact fault
    timeline."""
    armed = _disk_armed.get(kind)
    if armed is None:
        return 0.0
    _p, random = armed
    return random.next_int(1000) / 1000.0


def arm_disk_faults_from_env(spec: Optional[str] = None) -> Dict[str, float]:
    """Parse ``kind:probability:seed[,...]`` (the ACCORD_TPU_DISK_FAULTS
    format) and arm each class.  Returns {kind: probability}."""
    import os
    if spec is None:
        spec = os.environ.get(DISK_FAULTS_ENV, "")
    armed = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        kind, prob, seed = part.split(":")
        inject_disk_fault(kind, float(prob), RandomSource(int(seed)))
        armed[kind] = float(prob)
    return armed


@contextlib.contextmanager
def disk_fault(kind: str, probability: float,
               random: RandomSource) -> Iterator[None]:
    """Arm ``kind`` for the block, restoring the prior arming on exit."""
    prior = _disk_armed.get(kind)
    inject_disk_fault(kind, probability, random)
    try:
        yield
    finally:
        if prior is None:
            _disk_armed.pop(kind, None)
        else:
            _disk_armed[kind] = prior


@contextlib.contextmanager
def enabled(name: str) -> Iterator[None]:
    """Flip a module-level boolean fault flag for the block::

        with faults.enabled("TRANSACTION_INSTABILITY"):
            ...

    replaces the hand-rolled try/finally around flag flips; typos raise
    (AttributeError) instead of silently testing nothing."""
    mod = sys.modules[__name__]
    prev = getattr(mod, name)
    if not isinstance(prev, bool):
        raise ValueError(f"faults.{name} is not a boolean fault flag")
    setattr(mod, name, True)
    try:
        yield
    finally:
        setattr(mod, name, prev)
