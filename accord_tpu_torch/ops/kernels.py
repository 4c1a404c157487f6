"""The one place that sends each kernel call to the CUDA kernel or to its
plain PyTorch version.

The choice is made by the device of the tensors the caller hands in: a CPU
tensor takes the plain version (the CPU tests and ``--device cpu`` runs); a
CUDA tensor launches the hand-written kernel from ``ops/csrc`` (built by
``ops._build``) or raises.  There is no fallback from a failed build or
launch to the plain version.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else, so a run can show that its path went through the
kernels.  The wrappers allocate every output and scratch buffer with
``torch.empty``; the kernels run on PyTorch's current stream.

| name           | replaces (accord_tpu/...)                               |
|----------------|---------------------------------------------------------|
| deps_bucketed  | ops/deps_kernel.py:448 bucketed_flat (+ _compact_rows)  |
| deps_dense     | ops/deps_kernel.py:351 flat_csr_local (+ _compact_rows) |
| attr_post      | ops/deps_kernel.py:921 _attr_post                       |
| scatter_rows   | ops/deps_kernel.py:156, :839; local/device_index.py:226, :1084 |
| frontier_ell   | ops/drain_kernel.py:173 ready_frontier_ell              |
| frontier_dense | ops/drain_kernel.py:133 ready_frontier                  |
| fused_deps_dense | ops/deps_kernel.py:605 fused_flat_csr (raw stage of :1081) |
| fused_attr_post  | ops/deps_kernel.py:1081 fused_flat_attr (attribution) |
| fused_frontier_ell   | ops/drain_kernel.py:244 fused_ready_frontier_ell  |
| fused_frontier_dense | ops/drain_kernel.py:214 fused_ready_frontier      |
| level_ell      | ops/drain_kernel.py:397 level_assign_ell                |
| level_dense    | ops/drain_kernel.py:421 level_assign_dense              |
| drain_fix_dense | ops/drain_kernel.py:126 drain_levels (:115 drain; :87)  |
| drain_fix_ell  | ops/drain_kernel.py:300 drain_ell_levels (:292; :274)   |
| logsq_dense    | ops/drain_kernel.py:489 drain_dense_logsq               |
| dense_degree   | ops/drain_kernel.py:524 _dense_degree                   |
| dense_to_ell   | ops/drain_kernel.py:539 dense_to_ell (the convert at :554) |
| calc_deps      | ops/deps_kernel.py:217 calculate_deps (+ packing.py:84)  |
| ts_max         | ops/packing.py:84 masked_ts_max (parallel/sharded.py:98-106) |
| merge_blocks   | parallel/sharded.py:425 _merge_shard_blocks              |
| sharded_frontier | parallel/sharded.py:174 sharded_ready_frontier         |
| sharded_drain  | parallel/sharded.py:124 sharded_drain (one launch a sweep) |
| sharded_drain_fix | parallel/sharded.py:124 sharded_drain (one launch)    |
| attr_tok       | parallel/sharded.py:566-576 (the token psum's terms)     |

The fused kernels read every member store's tensors where they lie.  K5
and K6 (dense and ELL) pass each member's pointers and sizes by value in
their kernel parameter (up to ``FUSED_MAX_STORES`` members a launch,
packed once into each column set's plan; a larger group splits into
launches), and K6 runs a flat grid of (member, row group) CTAs whose plan
is a cached function of the members' sizes (``fused_frontier_launches``).
The mesh kernels read the slices of one device the same way: their
wrappers take the slices that lie on one device and launch once for them
(K11, K12, K13 and K2's ``attr_tok`` pass the slices' or blocks' pointers
in the kernel parameter instead, up to ``SHARDED_MAX_SLICES``,
``MERGE_MAX_REFS`` and ``TOK_MAX_REFS``; K12 uploads a table over its
limit, ``attr_tok`` splits its rows into more launches).  K3 handed numpy
packs its index and rows into one pinned staging buffer (``StagingRing``)
and uploads it in one copy.  K4 and K6 may write their flags straight
into a pinned host buffer (the drain ticks').

K9's level-drain epilogue (ops/drain_kernel.py:427 ``_levels_to_drain``
and the depth, in :434, :451, :465 and :479) has no launch of its own: it
runs inside K7's launch (``level_drain_ell`` / ``level_drain_dense``),
which counts as a ``level_ell`` / ``level_dense`` launch, and each such
call adds one to ``EPILOGUES["level_drain"]``.

A non-zero return code of an entry point raises ``launch_error``'s
exception: ``faults.CudaLaunchError`` for a launch refused for want of
resources, which the device fault ladder fails over on, or a plain
RuntimeError for every other code (a lost context, an invalid argument, a
library not built for this card), which propagates.
"""

from __future__ import annotations

import functools
import threading
import weakref
from array import array
from typing import Dict, Sequence

import numpy as np
import torch

from ..utils import faults
from . import _build
from . import deps_kernel as dk
from . import drain_kernel as drk

KERNELS = ("deps_bucketed", "deps_dense", "attr_post", "scatter_rows",
           "frontier_ell", "frontier_dense", "fused_deps_dense",
           "fused_attr_post", "fused_frontier_ell", "fused_frontier_dense",
           "level_ell", "level_dense", "drain_fix_dense", "drain_fix_ell",
           "logsq_dense", "dense_degree", "dense_to_ell",
           "calc_deps", "ts_max", "merge_blocks", "sharded_frontier",
           "sharded_drain", "sharded_drain_fix", "attr_tok")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# the calls that ran a fused epilogue inside another kernel's launch (not
# launches of their own)
EPILOGUES: Dict[str, int] = {"level_drain": 0}

# candidates a row of deps_bucketed sorts in shared memory (SMEM_CODES of
# csrc/deps_scan.cu); a row with more sorts in its CTA's global scratch
SMEM_CODES = 4096


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
    for k in EPILOGUES:
        EPILOGUES[k] = 0


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _ptr(t) -> int:
    if t is None:
        return 0
    if isinstance(t, int):
        return t
    if not t.is_cuda:
        raise ValueError("kernel argument is not on a CUDA device")
    if not t.is_contiguous():
        raise ValueError("kernel argument is not contiguous")
    return t.data_ptr()


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    return t


_I64, _I32, _B = torch.int64, torch.int32, torch.bool
# the column dtypes each kernel reads through a raw pointer
_DTYPES = {
    dk.DepsTable: (_I64, _I64, _I32, _I32, _I32, _I64, _I64),
    dk.BucketTable: (_I64, _I64, _I32, _I32, _I64, _I64, _I32, _I32) * 2,
    dk.AttrCols: (_I32, _I32, _I64, _I64, _I32, _I64, _I64, _I32, _B),
    dk.AttrIndex: (_I64, _I64, _I64, _I32, _I64, _I32, _I64, _I64, _I64,
                   _I32, _I64),
    drk.DrainState: (_B, _I32, _I64, _I64, _I32, _B),
    drk.EllDrainState: (_I32, _I32, _I64, _I64, _I32, _B),
}


def _check_cols(nt) -> None:
    """Every column of a kernel input has the dtype the kernel reads."""
    for i, (col, dtype) in enumerate(zip(nt, _DTYPES[type(nt)])):
        if col.dtype != dtype:
            raise TypeError(f"{type(nt).__name__}.{nt._fields[i]}: expected "
                            f"{dtype}, got {col.dtype}")


# A column set checked once for its lifetime carries its plan: the
# device its columns all lie on, contiguous (None if they do not), their
# data pointers, their first-axis lengths, and the launch values wrappers
# have packed from them (``_values``).  The mirrors make such a set
# where they build or replace one (``checked_cols``), so the plan lives and
# dies with the tuple they keep; a wrapper handed any other set checks it
# on every call.  A NamedTuple is immutable and the mirrors write rows in
# place, so a plan stays true for its tuple; ``_replace`` and a copy make
# a tuple without one.
_PLANNED: Dict[type, type] = {}   # column set type -> its planned type


def _planned(cls):
    """The subclass of column set type ``cls`` whose instances carry a
    ``_plan`` (``cls`` itself if it is one); a copy of one
    (``__getstate__``) does not."""
    sub = _PLANNED.get(cls)
    if sub is None:
        sub = type(cls.__name__, (cls,), {"__getstate__": lambda self: None})
        _DTYPES[sub] = _DTYPES[cls]
        _PLANNED[cls] = _PLANNED[sub] = sub
    return sub


def _plan(nt) -> tuple:
    """(device or None, data pointers, first-axis lengths, packed launch
    values by builder) of column set ``nt``, its dtypes checked (one pass
    over the columns: a drain tick plans a new state almost every call)."""
    want = _DTYPES[type(nt)]
    idx = nt[0].get_device()
    same = True
    ptrs, lens = [], []
    for k, c in enumerate(nt):
        if c.dtype is not want[k]:
            raise TypeError(f"{type(nt).__name__}.{nt._fields[k]}: expected "
                            f"{want[k]}, got {c.dtype}")
        same = same and c.get_device() == idx and c.is_contiguous()
        ptrs.append(c.data_ptr())
        shape = c.shape
        lens.append(shape[0] if shape else 1)
    return (nt[0].device if same else None, ptrs, lens, {})


def checked_cols(nt):
    """``nt`` (a kernel input column set) as a tuple of the same columns
    that carries its checked plan."""
    if getattr(nt, "_plan", None) is not None:
        return nt
    out = _planned(type(nt))(*nt)
    out._plan = _plan(nt)
    return out


def _plan_on(nt, dev: torch.device) -> tuple:
    """The plan of a column set that lies, contiguous, on ``dev``; raises
    otherwise."""
    plan = getattr(nt, "_plan", None) or _plan(nt)
    if plan[0] != dev:
        raise ValueError(f"{type(nt).__name__}: its columns are not all "
                         f"contiguous on {dev}")
    return plan


def _cols_on(nt, dev: torch.device) -> tuple:
    """(data pointers, first-axis lengths) of a column set that lies,
    contiguous, on ``dev``; raises otherwise."""
    plan = _plan_on(nt, dev)
    return plan[1], plan[2]


def _values(nt, dev: torch.device, build) -> tuple:
    """``build(nt, plan)``: (int64 launch values packed as bytes, *sizes)
    of a column set that lies, contiguous, on ``dev``.  Its plan keeps
    them, so a planned set's are built once."""
    plan = getattr(nt, "_plan", None)
    if plan is None or plan[0] != dev:
        plan = _plan_on(nt, dev)
    v = plan[3].get(build)
    if v is None:
        v = plan[3][build] = build(nt, plan)
    return v


# cudaError_t codes of a launch the runtime refused for want of resources
# (memory allocation, out of resources, a cooperative grid over the
# resident limit): the run-time refusals the reference's XlaRuntimeError
# covers, which leave the context usable
_RESOURCE = frozenset({2, 701, 720})
# cudaError_t codes that leave the CUDA context unusable (illegal address,
# launch timeout, device-side assert, hardware stack error, illegal
# instruction, misaligned address, invalid address space, invalid pc,
# launch failure): every later call returns them too
_STICKY = frozenset({700, 702, 710, 714, 715, 716, 717, 718, 719})

# the current stream's cudaStream_t of a device index, without building a
# torch.cuda.Stream (absent from builds without CUDA)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch_error(name: str, rc: int, message: str) -> RuntimeError:
    """The exception for a non-zero return code ``rc`` of kernel ``name``'s
    entry point.  A launch refused for want of resources (memory, threads
    or registers, a cooperative grid over the resident limit) is a
    ``faults.CudaLaunchError``: the device fault ladder quarantines and
    fails over on it.  Every other code is a plain RuntimeError, which
    propagates: a sticky code means the context is lost, and the rest (an
    invalid argument, no image of the kernel for this card) mean the
    library or its wrapper is wrong, which no host route may hide."""
    text = f"CUDA kernel {name} failed to launch: error {rc} ({message})"
    if rc in _RESOURCE:
        return faults.CudaLaunchError(text, rc)
    if rc in _STICKY:
        return RuntimeError(text + "; the CUDA context is lost")
    return RuntimeError(text + "; a fault of the kernel library's build "
                        "or of its wrapper")


# the current device index, read without torch.cuda's lazy-init check
_current_device = (getattr(torch._C, "_cuda_getDevice", None)
                   or torch.cuda.current_device)


def _launch(name: str, device: torch.device, ptrs, vals,
            entry: str = None) -> None:
    """Call entry point ``entry`` (default ``name``) with the data pointers
    of ``ptrs`` (tensors, None for null, or int addresses) and the integers
    ``vals`` (a list, or an ``array("q")`` already packed), on the current
    stream of ``device``.  The entry point is resolved once and the
    argument arrays are packed by ``array`` in C; ``_launch_packed``
    makes the call."""
    p = array("Q", [t if type(t) is int else _ptr(t) for t in ptrs])
    v = vals if type(vals) is array else array("q", vals)
    idx = _current_device() if device.index is None else device.index
    _launch_packed(name, idx, _build.entries()[entry or name],
                   p.buffer_info()[0], v.buffer_info()[0])


def _launch_packed(name: str, idx: int, fn, p: int, v: int) -> None:
    """Call entry point ``fn`` with ``p`` and ``v``, the addresses of the
    packed pointer and value arrays (which the caller keeps alive), on the
    current stream of device index ``idx``, switching the device only
    when it is not the current one.  A non-zero return code raises
    ``launch_error``'s exception; ``name`` counts a launch when it is one
    of ``KERNELS`` (a probe is not)."""
    stream = (_raw_stream(idx) if _raw_stream is not None
              else torch.cuda.current_stream(idx).cuda_stream)
    if idx == _current_device():
        rc = fn(p, v, stream)
    else:
        with torch.cuda.device(idx):
            rc = fn(p, v, stream)
    if rc != 0:
        raise launch_error(
            name, rc, _build.library().accord_error_string(rc).decode())
    if name in LAUNCHES:
        LAUNCHES[name] += 1


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _prune_vals(prune):
    if prune is None:
        return 0, 0, 0
    return int(prune[0]), int(prune[1]), int(prune[2])


# -- K1: the deps scan --------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _bucketed_workspace_words(b: int, c: int, kk: int, wide: bool) -> int:
    """The int64 words of K1a's workspace, as its entry point lays it
    out."""
    return _build.library().accord_bucketed_workspace_words(b, c, kk,
                                                            int(wide))


def deps_bucketed(m_t: int, buckets: dk.BucketTable, qmat: torch.Tensor,
                  m: int, span: int, s: int, k: int, prune=None,
                  keff: int = None, wide: bool = False,
                  row_offset: int = None):
    """Bucketed exact CSR (header int32[2+B], entries[s]); ``row_offset``
    for a row-sharded slice of the bucket table.  A bucket table that
    carries its plan (``checked_cols``) is not checked again; the
    entries, the header and the workspace are one allocation."""
    if not on_cuda(qmat):
        return dk.bucketed_flat_plain(m_t, buckets, qmat, m, span, s, k,
                                      prune, keff, wide, row_offset)
    if qmat.dtype is not torch.int64:
        raise TypeError(f"qmat: expected torch.int64, got {qmat.dtype}")
    dev = qmat.device
    cols, lens = _cols_on(buckets, dev)
    b, qcols = qmat.shape
    if qcols != 7 + 2 * m + m * span:
        raise ValueError(f"qmat has {qcols} columns, expected "
                         f"{7 + 2 * m + m * span}")
    kb = buckets.blo.shape[1]
    keff = kb if keff is None else min(keff, kb)
    w = lens[8]
    c = m * span * keff + m * w
    kk = min(k, c)
    words = _bucketed_workspace_words(b, c, kk, wide)
    # one allocation a call: the entries, the header (int32[2+B]), then
    # the workspace, each at a whole int64 word (two views a call)
    n_out = s if wide else (s + 1) // 2
    n_hdr = (3 + b) // 2
    if wide:
        buf = torch.empty(n_out + n_hdr + words, dtype=torch.int64,
                          device=dev)
        ent = buf[:s]
        hdr = buf.view(torch.int32)[2 * s:2 * s + 2 + b]
    else:
        buf = torch.empty(2 * (n_out + n_hdr + words), dtype=torch.int32,
                          device=dev)
        ent = buf[:s]
        hdr = buf[2 * n_out:2 * n_out + 2 + b]
    base = buf.data_ptr()
    pm, pl, pn = _prune_vals(prune)
    _launch("deps_bucketed", dev,
            [qmat, *cols, base + 8 * (n_out + n_hdr), base + 8 * n_out,
             base],
            [b, qcols, m, span, kb, keff, w, pm, pl, pn, m_t, int(wide), s,
             k, int(row_offset is not None), int(row_offset or 0), lens[0],
             words])
    return hdr, ent


@functools.lru_cache(maxsize=256)
def _dense_workspace_words(b: int, n: int) -> int:
    """The int64 words of K1b's workspace, as its entry point lays it out."""
    return _build.library().accord_dense_workspace_words(b, n)


@functools.lru_cache(maxsize=256)
def _attr_workspace_words(s: int) -> int:
    """The int64 words of K2's workspace, as its entry point lays it out."""
    return _build.library().accord_attr_workspace_words(s)


def deps_dense(table: dk.DepsTable, qmat: torch.Tensor, m: int, s: int,
               k: int, prune=None, wide: bool = False):
    """Dense exact CSR (header int32[2+B], entries[s])."""
    if not on_cuda(qmat):
        return dk.flat_csr_plain(table, qmat, m, s, k, prune, wide)
    if qmat.dtype is not torch.int64:
        raise TypeError(f"qmat: expected torch.int64, got {qmat.dtype}")
    dev = qmat.device
    cols, _ = _cols_on(table, dev)
    b, qcols = qmat.shape
    if qcols != 7 + 2 * m:
        raise ValueError(f"qmat has {qcols} columns, expected {7 + 2 * m}")
    n, m_t = table.lo.shape
    words = _dense_workspace_words(b, n)
    ws = torch.empty(words, dtype=torch.int64, device=dev)
    hdr = torch.empty(2 + b, dtype=torch.int32, device=dev)
    ent = torch.empty(s, dtype=torch.int64 if wide else torch.int32,
                      device=dev)
    pm, pl, pn = _prune_vals(prune)
    _launch("deps_dense", dev,
            [qmat, *cols, ws.data_ptr(), hdr.data_ptr(), ent.data_ptr()],
            [b, qcols, m, n, m_t, pm, pl, pn, int(wide), s, k, words])
    return hdr, ent


# -- K2: post-compaction attribution -----------------------------------------

def attr_post(tlo: torch.Tensor, attr: dk.AttrCols, aidx: dk.AttrIndex,
              rankb: torch.Tensor, hdr_raw: torch.Tensor, ent: torch.Tensor,
              m_t: int, m: int, floors: bool = True, elide: bool = True,
              tok: torch.Tensor = None):
    """Attributed CSR (header int32[5+B], entries[s]) from the raw one;
    ``tok`` (int64[s]) replaces the token gather from ``tlo``.  A column
    set that carries its plan (``checked_cols``) is not checked again."""
    if not on_cuda(ent):
        return dk.attr_post_plain(tlo, attr, aidx, rankb, hdr_raw, ent, m_t,
                                  m, floors, elide, tok)
    dev = ent.device
    acols, alens = _cols_on(attr, dev)
    icols, ilens = _cols_on(aidx, dev)
    s = ent.shape[0]
    b = hdr_raw.shape[0] - 2
    if rankb.dtype is not torch.int64 or hdr_raw.dtype is not torch.int32:
        raise TypeError("attr_post: rankb must be int64 and hdr_raw int32")
    if tok is None:
        if tlo.dtype is not torch.int64 or tlo.shape != (alens[0], m_t):
            raise ValueError("attr_post: tlo does not fit the attribution "
                             "columns")
    elif tok.dtype is not torch.int64 or tok.shape != (s,):
        raise ValueError("attr_post: tok does not fit the entries")
    if rankb.shape[0] != b:
        raise ValueError("attr_post: rankb does not fit the header")
    words = _attr_workspace_words(s)
    # one allocation a call: the entries, the header (int32[5+B]), then
    # the scratch, each at a whole int64 word
    n_out = s if ent.dtype == torch.int64 else (s + 1) // 2
    n_hdr = (6 + b) // 2
    buf = torch.empty(n_out + n_hdr + words, dtype=torch.int64, device=dev)
    out = buf[:n_out].view(ent.dtype)[:s]
    hdr = buf[n_out:n_out + n_hdr].view(torch.int32)[:5 + b]
    _launch("attr_post", dev,
            [None if tok is not None else tlo, *acols, *icols, rankb,
             hdr_raw, ent, buf.data_ptr() + 8 * (n_out + n_hdr),
             hdr.data_ptr(), out.data_ptr(), tok],
            [s, b, m_t, m, int(floors), int(elide), ilens[0], ilens[4],
             ilens[6], int(ent.dtype == torch.int64), words])
    return hdr, out


# -- K3: dirty-row scatter ----------------------------------------------------

# columns one scatter takes (MAX_COLS of csrc/scatter_rows.cu)
SCATTER_MAX_COLS = _build.LIMITS["ACCORD_SCATTER_MAX_COLS"]


class StagingRing:
    """Host staging buffers for K3's one upload a call, reused round-robin.
    The copy to the device is asynchronous, so a buffer is written again
    only after the event recorded behind its last copy has completed:
    ``take`` waits on it.  Four slots: a store's flush makes up to three
    scatters (its table, bucket rows and attribution columns) before it
    waits on its results, so they never wait on one another.  A buffer
    over ``keep`` bytes serves the call that needed it and is given back
    (to PyTorch's pinned-memory cache) when its slot is next taken for
    less.  ``event`` makes the events
    (``torch.cuda.Event`` on the card)."""

    def __init__(self, slots: int = 4, pin: bool = True, event=None,
                 keep: int = 1 << 20) -> None:
        self.pin = pin
        self.event = event or torch.cuda.Event
        self.keep = keep
        self.bufs = [None] * slots
        self.marks = [None] * slots     # each slot's event, made once
        self.pending = [False] * slots  # its mark is behind a copy
        self.next = 0
        self.lock = threading.Lock()

    def take(self, nbytes: int):
        """(slot, uint8 host tensor of at least ``nbytes``) free to write."""
        i = self.next
        self.next = (i + 1) % len(self.bufs)
        if self.pending[i]:
            self.marks[i].synchronize()
            self.pending[i] = False
        want = _next_pow2(max(nbytes, 4096))
        buf = self.bufs[i]
        if buf is None or buf.numel() < nbytes \
                or buf.numel() > max(want, self.keep):
            self.bufs[i] = None     # given back before the new one comes
            buf = self.bufs[i] = torch.empty(want, dtype=torch.uint8,
                                             pin_memory=self.pin)
        return i, buf

    def copied(self, slot: int, stream=None) -> None:
        """The copy out of ``slot``'s buffer is enqueued on ``stream``."""
        if self.marks[slot] is None:
            self.marks[slot] = self.event()
        self.marks[slot].record(stream)
        self.pending[slot] = True


_RINGS: Dict[int, StagingRing] = {}

# a staging payload this large is packed by several threads (numpy's
# copies release the GIL), one smaller by the caller's.  chip_smoke.py's
# pack timings on the one-card H100 machine (8 host cores): the pool
# loses up to 3.1 MB (handing work to threads costs about 1 ms), wins at
# 50 MB (3.3-5.1 ms against 9.0-10.0) and is a toss-up at 12.6 MB; the
# main path's payloads are under 4 MB but for two over 8 MB (100.8 MB)
PACK_PARALLEL_BYTES = 1 << 23
PACK_WORKERS = 8
_POOL = None


def _pack_pool():
    global _POOL
    if _POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _POOL = ThreadPoolExecutor(max_workers=PACK_WORKERS,
                                   thread_name_prefix="accord-pack")
    return _POOL


def _as(t: torch.Tensor, dev: torch.device, dtype) -> torch.Tensor:
    """``t`` contiguous, of ``dtype``, on ``dev`` (no copy when it is)."""
    if t.dtype is dtype and t.is_contiguous() \
            and t.get_device() == (dev.index if dev.type == "cuda" else -1):
        return t
    return t.to(device=dev, dtype=dtype).contiguous()


def _scatter_launch(dev, cols, idx_ptr: int, srcs, p: int) -> None:
    """K3 over ``cols``, whose P source rows lie at the addresses
    ``srcs``, the int64 index at ``idx_ptr``."""
    ptrs, vals = [idx_ptr], [len(cols), p]
    for c, src in zip(cols, srcs):
        if c.get_device() != dev.index or not c.is_contiguous():
            raise ValueError(f"scatter column is not a contiguous tensor "
                             f"on {dev}")
        ptrs += (c.data_ptr(), src)
        vals.append(dk.row_bytes(c))
    _launch("scatter_rows", dev, ptrs, vals)


def scatter_rows(cols: Sequence[torch.Tensor], idx,
                 rows: Sequence) -> None:
    """In place: ``cols[c][idx] = rows[c]`` for every column.  Tensors are
    read where they lie (no copy on the card); numpy ``idx`` and ``rows``
    are packed into one staging buffer (``dk.pack_layout``) and uploaded
    in one copy, which the kernel reads at offsets."""
    dev = cols[0].device
    if len(cols) > SCATTER_MAX_COLS or len(rows) != len(cols):
        raise ValueError(f"scatter_rows takes 1 to {SCATTER_MAX_COLS} "
                         f"columns and one row array each, got {len(cols)} "
                         f"and {len(rows)}")
    p = len(idx)
    if p == 0:
        return
    on_card = on_cuda(cols[0])
    if torch.is_tensor(idx):
        idx_t = _as(idx, dev, torch.int64)
        rows_t = [_as(r, dev, c.dtype) for c, r in zip(cols, rows)]
        for c, r in zip(cols, rows_t):
            if r.shape[0] != p or r.shape[1:] != c.shape[1:]:
                raise ValueError(f"scatter rows {tuple(r.shape)} do not fit "
                                 f"column {tuple(c.shape)}")
        if not on_card:
            dk.scatter_rows_plain(cols, idx_t, rows_t)
            return
        _scatter_launch(dev, cols, idx_t.data_ptr(),
                        [r.data_ptr() for r in rows_t], p)
        return
    offs, total = dk.pack_layout(cols, p)
    if not on_card:
        buf = np.empty(total, np.uint8)
        dk.pack_rows(buf, cols, idx, rows, offs)
        dk.scatter_rows_packed_plain(cols, torch.from_numpy(buf), p, offs)
        return
    ring = _RINGS.get(dev.index)
    if ring is None:
        ring = _RINGS[dev.index] = StagingRing()
    with ring.lock:
        slot, host = ring.take(total)
        dk.pack_rows(host.numpy(), cols, idx, rows, offs,
                     _pack_pool() if total >= PACK_PARALLEL_BYTES else None,
                     PACK_WORKERS)
        staged = torch.empty(total, dtype=torch.uint8, device=dev)
        staged.copy_(host[:total], non_blocking=True)
        ring.copied(slot, None if dev.index == torch.cuda.current_device()
                    else torch.cuda.current_stream(dev))
    base = staged.data_ptr()
    _scatter_launch(dev, cols, base, [base + o for o in offs], p)


# -- K4: drain frontier -------------------------------------------------------

# A frontier's plan packs its state's column pointers and its launch
# values, with its entry point resolved (once for a planned state, on
# each call for any other); each call adds the output's pointer.

def _dense_n(st, plan) -> int:
    """N of a dense drain state whose adjacency is [N, N]."""
    n = plan[2][1]
    if st.adj.shape != (n, n):
        raise ValueError(f"adjacency {tuple(st.adj.shape)} is not "
                         f"[{n}, {n}]")
    return n


def _dense_frontier_values(st, plan):
    n = _dense_n(st, plan)
    return (array("Q", plan[1]), array("q", [n]), n,
            _build.entries()["frontier_dense"])


def _ell_shape(st, plan) -> tuple:
    """(N, D) of an ELL drain state whose columns hold N rows."""
    n, d = st.adj_idx.shape
    if plan[2][1] != n:
        raise ValueError(f"adjacency {tuple(st.adj_idx.shape)} does not fit "
                         f"{plan[2][1]} rows")
    return n, d


def _ell_frontier_values(st, plan):
    n, d = _ell_shape(st, plan)
    return (array("Q", plan[1]), array("q", [n, d]), n,
            _build.entries()["frontier_ell"])


def _flags_out(out, shape, dev: torch.device) -> torch.Tensor:
    """A frontier's output: ``out`` (None: a new bool tensor of ``shape``
    on ``dev``), which must be a contiguous bool tensor of ``shape`` on
    ``dev``, or, for a card, in pinned host memory, which the card maps."""
    if out is None:
        return torch.empty(shape, dtype=torch.bool, device=dev)
    if out.dtype is not torch.bool or out.shape != shape \
            or not out.is_contiguous():
        raise ValueError(f"frontier out: expected a contiguous bool"
                         f"{list(shape)}")
    if dev.type == "cpu":
        if out.device.type != "cpu":
            raise ValueError(f"frontier out lies on {out.device}, not on "
                             f"the CPU")
    elif out.get_device() != dev.index if out.is_cuda \
            else not out.is_pinned():
        raise ValueError(f"frontier out lies on {out.device}: neither on "
                         f"{dev} nor in pinned host memory")
    return out


def _plain_into(ready: torch.Tensor, out) -> torch.Tensor:
    """A plain frontier's flags, copied into ``out`` when one is given
    (checked as ``_flags_out`` checks it on the CPU)."""
    if out is None:
        return ready
    return _flags_out(out, ready.shape, ready.device).copy_(ready)


def _frontier(name: str, state, build, out) -> torch.Tensor:
    """A frontier launch into ``out`` (None: a new tensor): bool[n],
    contiguous, on the state's device or in pinned host memory, which
    the card maps."""
    dev = state.status.device
    cols, vals, n, fn = _values(state, dev, build)
    out = _flags_out(out, (n,), dev)
    p = cols + array("Q", (out.data_ptr(),))
    _launch_packed(name, dev.index, fn, p.buffer_info()[0],
                   vals.buffer_info()[0])
    return out


def frontier_ell(state: drk.EllDrainState, out=None) -> torch.Tensor:
    """bool[N]: which rows are ready.  ``out`` (bool[N] on the state's
    card, or pinned host memory, which the kernel writes over the bus)
    takes the flags in place of a new tensor.  A planned state
    (``checked_cols``) is not checked again."""
    if not on_cuda(state.status):
        return _plain_into(drk.ready_frontier_ell_plain(state), out)
    return _frontier("frontier_ell", state, _ell_frontier_values, out)


def frontier_dense(state: drk.DrainState, out=None) -> torch.Tensor:
    """bool[N]: which rows are ready.  ``out`` (bool[N] on the state's
    card, or pinned host memory, which the kernel writes over the bus)
    takes the flags in place of a new tensor.  A planned state
    (``checked_cols``) is not checked again."""
    if not on_cuda(state.status):
        return _plain_into(drk.ready_frontier_plain(state), out)
    return _frontier("frontier_dense", state, _dense_frontier_values, out)


# -- K5: fused multi-store deps scan + attribution ----------------------------

# member stores a K5 launch takes by value (MAX_STORES of
# csrc/fused_scan.cu); a larger group is split into launches
FUSED_MAX_STORES = _build.LIMITS["ACCORD_FUSED_MAX_STORES"]


# a K5 member's launch values, with the sizes the launch takes maxima of
def _scan_values(t, plan):
    # the table's 7 columns, n, m_t
    n, m_t = t.lo.shape
    return array("q", [*plan[1], n, m_t]).tobytes(), n, m_t


def _lo_values(t, plan):
    # the table's lo, n, m_t
    n, m_t = t.lo.shape
    return array("q", [plan[1][5], n, m_t]).tobytes(), n, m_t


def _ptr_values(_a, plan):
    # the 9 attribution columns
    return array("q", plan[1]).tobytes(), plan[2][0]


def _index_values(_x, plan):
    # the 11 index arrays, F, T, L
    ftl = plan[2][0], plan[2][4], plan[2][6]
    return array("q", [*plan[1], *ftl]).tobytes(), *ftl


@functools.lru_cache(maxsize=256)
def _fused_scan_words(n_s: int, b: int, w: int) -> int:
    """The int64 words of K5's scan workspace, as its entry point lays it
    out, for ``n_s`` members of ``b`` rows and ``w`` mask words a row in
    all."""
    return _build.library().accord_fused_scan_workspace_words(n_s, b, w)


@functools.lru_cache(maxsize=256)
def _fused_attr_words(n_s: int, s: int) -> int:
    """The int64 words of K5's attribution workspace."""
    return _build.library().accord_fused_attr_workspace_words(n_s, s)


def _fused_buffer(dev, n_s: int, s: int, b_hdr: int, wide: bool,
                  words: int):
    """One allocation for a K5 stage: the entries [S, s], the header
    int32[S, b_hdr] and the workspace, each at a whole int64 word.
    Returns (entries, header, workspace address)."""
    n_out = n_s * s if wide else (n_s * s + 1) // 2
    n_hdr = (n_s * b_hdr + 1) // 2
    buf = torch.empty(n_out + n_hdr + words, dtype=torch.int64, device=dev)
    b32 = buf.view(torch.int32)
    ent = (buf if wide else b32).as_strided((n_s, s), (s, 1))
    hdr = b32.as_strided((n_s, b_hdr), (b_hdr, 1), 2 * n_out)
    return ent, hdr, buf.data_ptr() + 8 * (n_out + n_hdr)


def _chunks(n_s: int):
    """(first, last) member of each launch of a group of ``n_s``."""
    return [(i, min(i + FUSED_MAX_STORES, n_s))
            for i in range(0, n_s, FUSED_MAX_STORES)]


def fused_deps_dense(tables: Sequence[dk.DepsTable], qmats: torch.Tensor,
                     prunes, m: int, s: int, k: int, wide: bool = False):
    """Dense exact CSR for S stores: (header int32[S, 2+B], entries
    [S, s]); codes on the group's m_max.  One launch for up to
    ``FUSED_MAX_STORES`` members, each member's columns and prune floor
    passed by value; a member's table that carries its plan
    (``checked_cols``) is not checked again.  The entries, the header and
    the workspace are one allocation."""
    if not on_cuda(qmats):
        return dk.fused_flat_csr_plain(tables, qmats, prunes, m, s, k, wide)
    dev = qmats.device
    _check(qmats, torch.int64, "qmats")
    n_s, b, qcols = qmats.shape
    if n_s != len(tables) or qcols != 7 + 2 * m:
        raise ValueError(f"qmats {tuple(qmats.shape)} do not fit {len(tables)}"
                         f" stores and {7 + 2 * m} query columns")
    vals = [_values(t, dev, _scan_values) for t in tables]
    parts, ns, mts = zip(*vals)
    n_max, m_max = max(ns), max(mts)
    w = sum([(n + 31) >> 5 for n in ns])
    pr = np.empty((n_s, 3), np.int64)
    for c in range(3):
        pr[:, c] = prunes[c]
    words = _fused_scan_words(n_s, b, w)
    ent, hdr, wsp = _fused_buffer(dev, n_s, s, 2 + b, wide, words)
    q0, h0, e0 = _ptr(qmats), hdr.data_ptr(), ent.data_ptr()
    cs = 8 if wide else 4
    for i0, i1 in _chunks(n_s):
        v = array("q", (i1 - i0, b, qcols, m, n_max, m_max, int(wide), s, k,
                        words))
        v.frombytes(b"".join(parts[i0:i1]))
        v.frombytes(pr[i0:i1].tobytes())
        _launch("fused_deps_dense", dev,
                [q0 + 8 * i0 * b * qcols, wsp, h0 + 4 * i0 * (2 + b),
                 e0 + cs * i0 * s], v)
    return hdr, ent


def fused_attr_post(tables: Sequence[dk.DepsTable],
                    attrs: Sequence[dk.AttrCols],
                    aidxs: Sequence[dk.AttrIndex], rankbs: torch.Tensor,
                    hdr_raw: torch.Tensor, ent: torch.Tensor, m: int,
                    floors: bool = True, elide: bool = True):
    """Attributed CSRs (header int32[S, 5+B], entries [S, s]) of a fused
    raw CSR, each store over its own (group-padded) columns and index.
    One launch for up to ``FUSED_MAX_STORES`` members, their columns by
    value; column sets that carry their plan are not checked again; one
    allocation."""
    if not on_cuda(ent):
        return dk.fused_attr_post_plain(tables, attrs, aidxs, rankbs,
                                        hdr_raw, ent, m, floors, elide)
    dev = ent.device
    _check(rankbs, torch.int64, "rankbs")
    _check(hdr_raw, torch.int32, "hdr_raw")
    n_s, s = ent.shape
    b = hdr_raw.shape[1] - 2
    if rankbs.shape != (n_s, b) or hdr_raw.shape[0] != n_s \
            or len(tables) != n_s or len(attrs) != n_s or len(aidxs) != n_s:
        raise ValueError("fused_attr_post: rankbs / header shapes do not "
                         "fit the group")
    tvs = [_values(t, dev, _lo_values) for t in tables]
    avs = [_values(a, dev, _ptr_values) for a in attrs]
    ivs = [_values(x, dev, _index_values) for x in aidxs]
    if [a[1] for a in avs] != [t[1] for t in tvs]:
        raise ValueError("fused attribution columns do not fit the table")
    parts = [t[0] + a[0] + x[0] for t, a, x in zip(tvs, avs, ivs)]
    m_max = max([t[2] for t in tvs])
    f, t_, l_ = (max(c) for c in list(zip(*ivs))[1:])
    wide = ent.dtype == torch.int64
    words = _fused_attr_words(n_s, s)
    out, hdr, wsp = _fused_buffer(dev, n_s, s, 5 + b, wide, words)
    r0, hr0, e0 = _ptr(rankbs), _ptr(hdr_raw), _ptr(ent)
    h0, o0 = hdr.data_ptr(), out.data_ptr()
    cs = 8 if wide else 4
    for i0, i1 in _chunks(n_s):
        v = array("q", (i1 - i0, s, b, m_max, m, int(floors), int(elide), f,
                        t_, l_, int(wide), words))
        v.frombytes(b"".join(parts[i0:i1]))
        _launch("fused_attr_post", dev,
                [r0 + 8 * i0 * b, hr0 + 4 * i0 * (2 + b), e0 + cs * i0 * s,
                 wsp, h0 + 4 * i0 * (5 + b), o0 + cs * i0 * s], v)
    return hdr, out


# -- K6: fused multi-store frontier sweeps -------------------------------------

def _member_values(st, plan):
    # a K6 dense member's column pointers and n, packed; n
    n = _dense_n(st, plan)
    return array("q", [*plan[1], n]).tobytes(), n


def _ell_member_values(st, plan):
    # a K6 ELL member's column pointers, n and d, packed; n
    n, d = _ell_shape(st, plan)
    return array("q", [*plan[1], n, d]).tobytes(), n


# rows a K6 dense CTA takes (DENSE_ROWS of csrc/frontier.cu)
FRONTIER_ROWS = 8
# rows (a thread each) a K4a / K6 ELL CTA takes (ELL_ROWS of
# csrc/frontier.cu)
FRONTIER_ELL_ROWS = _build.GEOMETRY["ACCORD_FRONTIER_ELL_ROWS"]


@functools.lru_cache(maxsize=256)
def fused_frontier_launches(ns: tuple, n_max: int,
                            rows: int = FRONTIER_ROWS):
    """K6's launches for members of ``ns`` rows (a tuple: the plans of the
    sizes a group has are kept), padded to ``n_max``, a CTA ``rows`` rows
    of its member (8 dense, ``FRONTIER_ELL_ROWS`` ELL): for each launch of
    at most ``FUSED_MAX_STORES`` members, (first member, last member + 1,
    CTAs, [(the first row of the member's flags in the launch's output,
    its first CTA) per member]).  A member takes max(1, ceil(n / rows))
    CTAs (its last CTA writes its pad rows); a launch's output starts at
    its first member's row of the group's ``bool[S, n_max]``."""
    out = []
    for i0, i1 in _chunks(len(ns)):
        g, plan = 0, []
        for k, n in enumerate(ns[i0:i1]):
            plan.append((k * n_max, g))
            g += max(1, -(-n // rows))
        out.append((i0, i1, g, plan))
    return out


def _fused_frontier(name: str, states, build, rows: int,
                    out) -> torch.Tensor:
    """K6's launches (``fused_frontier_launches``, ``rows`` a CTA) over
    ``states`` (``build`` packs a member's values and gives its n) into
    ``out`` (None: a new tensor): bool[S, n_max], contiguous, on the
    states' device or in pinned host memory."""
    dev = states[0].status.device
    parts, ns = zip(*[_values(st, dev, build) for st in states])
    n_max = max(ns)
    out = _flags_out(out, (len(states), n_max), dev)
    base = out.data_ptr()
    for i0, i1, ctas, plan in fused_frontier_launches(ns, n_max, rows):
        v = array("q", (i1 - i0, n_max, ctas))
        for part, (row, g0) in zip(parts[i0:i1], plan):
            v.frombytes(part)
            v.extend((row, g0))
        _launch(name, dev, [base + i0 * n_max], v)
    return out


def fused_frontier_ell(states, out=None) -> torch.Tensor:
    """bool[S, n_max]: row i's first n_i flags are states[i]'s frontier,
    the rest false (pad rows are never ready; edges past a store's degree
    read as -1).  Each member's columns, n and d travel by value (up to
    ``FUSED_MAX_STORES`` a launch); ``out`` (bool[S, n_max] on the states'
    card, or pinned host memory, which the kernel writes over the bus)
    takes the flags in place of a new tensor."""
    if not on_cuda(states[0].status):
        return _plain_into(drk.fused_ready_frontier_ell_plain(states), out)
    return _fused_frontier("fused_frontier_ell", states, _ell_member_values,
                           FRONTIER_ELL_ROWS, out)


def fused_frontier_dense(states, out=None) -> torch.Tensor:
    """bool[S, n_max], dense adjacency per store (n_i x n_i): row i's
    first n_i flags are states[i]'s frontier, the rest false.  Each
    member's columns and size travel by value (up to ``FUSED_MAX_STORES``
    a launch); ``out`` (bool[S, n_max] on the states' card, or pinned
    host memory, which the kernel writes over the bus) takes the flags in
    place of a new tensor."""
    if not on_cuda(states[0].status):
        return _plain_into(drk.fused_ready_frontier_plain(states), out)
    return _fused_frontier("fused_frontier_dense", states, _member_values,
                           FRONTIER_ROWS, out)


# -- K7: log-depth level assignment, and K9's level-drain epilogue -----------

@functools.lru_cache(maxsize=64)
def _level_ell_words(n: int, d: int) -> int:
    """The int32 words of K7 ELL's workspace, its levels, rounds, depth
    and stats first, as its entry point lays it out."""
    return _build.library().accord_level_ell_workspace_words(n, d)


def _level_ell_values(st, plan):
    # K7 ELL's column pointers, N, D and workspace words
    n, d = st.adj_idx.shape
    if plan[2][1] != n:
        raise ValueError(f"adjacency {tuple(st.adj_idx.shape)} does not fit "
                         f"{plan[2][1]} rows")
    return array("Q", plan[1]), n, d, _level_ell_words(n, d)


@functools.lru_cache(maxsize=64)
def _level_dense_words(n: int) -> int:
    """The int32 words of K7 dense's workspace, its levels, rounds and
    depth first, as its entry point lays it out."""
    return _build.library().accord_level_dense_workspace_words(n)


def _level_values(st, plan):
    # K7 dense's column pointers, N and workspace words
    n = _dense_n(st, plan)
    return array("Q", plan[1]), n, _level_dense_words(n)


def _watermark(watermark, dev: torch.device) -> tuple:
    """(pointer, value, bytes) of a drain's watermark for the epilogue:
    none is ``lv < INF`` (``lv <= INF - 1``); an int or a CPU tensor goes
    by value; an int32 or int64 tensor of one element on ``dev`` is read
    by the kernel (no host synchronisation)."""
    if watermark is None:
        return 0, drk.LEVEL_INF - 1, 0
    if not torch.is_tensor(watermark):
        return 0, int(watermark), 0
    if watermark.numel() != 1:
        raise ValueError("watermark is not a scalar")
    if not watermark.is_cuda:
        return 0, int(watermark), 0
    if watermark.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"watermark: expected torch.int32 or torch.int64, "
                        f"got {watermark.dtype}")
    if watermark.get_device() != dev.index:
        raise ValueError(f"watermark on {watermark.device}, not on {dev}")
    return watermark.data_ptr(), 0, watermark.element_size()


def _level_launch(name: str, state, build, drain: bool, watermark=None):
    """One K7 launch on ``state``: its one allocation, the workspace
    (levels, rounds and depth first) and, with the level-drain epilogue
    (``drain``), the flags behind it (applied bool[N], newly bool[N]).
    Returns the allocation, N and the workspace words."""
    dev = state.status.device
    cols, n, *vals = _values(state, dev, build)
    words = vals[-1]
    if drain:
        wptr, wval, wbytes = _watermark(watermark, dev)
        buf = torch.empty(words + -(-2 * n // 4), dtype=torch.int32,
                          device=dev)
        base = buf.data_ptr()
        flags = (base + 4 * words, base + 4 * words + n, wptr)
    else:
        wval = wbytes = 0
        buf = torch.empty(words, dtype=torch.int32, device=dev)
        base, flags = buf.data_ptr(), (0, 0, 0)
    p = cols + array("Q", (base, *flags))
    v = array("q", (n, *vals, wval, wbytes))
    _launch_packed(name, dev.index, _build.entries()[name],
                   p.buffer_info()[0], v.buffer_info()[0])
    if drain:
        EPILOGUES["level_drain"] += 1
    return buf, n, words


def _drain_views(buf, n: int, words: int):
    """(applied, newly, rounds, depth) of a K7 launch with the epilogue:
    views of its one allocation, rounds and depth two adjacent words."""
    flags = buf[words:].view(torch.bool)
    return flags[:n], flags[n:2 * n], buf[n], buf[n + 1]


def _drain_plain(levels_plain, state, watermark):
    """(applied, newly, rounds, depth): the plain level pass, then the
    plain epilogue."""
    lv, rounds = levels_plain(state)
    applied, newly, depth = drk.level_drain_plain(state.status, lv,
                                                  watermark)
    return applied, newly, rounds, depth


def level_ell(state: drk.EllDrainState):
    """(levels int32[N], rounds int32[]) by one cooperative launch and one
    allocation: the levels and rounds are views of its workspace, which
    lives as long as they do (``level_assign_ell``'s callers, the drain
    tick and the log-depth drains, drop them within the call).  The
    device runs the rounds over the Stable rows only, in its first CTA
    where their state fits, else on the grid."""
    if not on_cuda(state.status):
        return drk.level_assign_ell_plain(state)
    buf, n, _words = _level_launch("level_ell", state, _level_ell_values,
                                   False)
    return buf[:n], buf[n]


def level_drain_ell(state: drk.EllDrainState, watermark=None):
    """The log-depth drain over the ELL adjacency: (applied bool[N], newly
    bool[N], rounds int32[], depth int32[]), K7 ELL's one launch with the
    level-drain epilogue (K9), one allocation; ``watermark`` (an int or a
    one-element tensor) replaces ``lv < INF`` by ``lv <= watermark``.
    Rounds and depth are adjacent words (one read takes both)."""
    if not on_cuda(state.status):
        return _drain_plain(drk.level_assign_ell_plain, state, watermark)
    return _drain_views(*_level_launch("level_ell", state,
                                       _level_ell_values, True, watermark))


def level_ell_stats(t: torch.Tensor) -> dict:
    """What the K7 ELL call that returned ``t`` (its levels, or its
    applied flags with the epilogue) found, read from its workspace (a
    synchronisation): its Stable rows ``A``, their list entries ``E``
    (gating deps that can change level, one for a row held at INF) and the
    ``form`` its rounds took ("first CTA" or "grid")."""
    n = t.shape[0]
    a, e, form = t._base[n + 2:n + 5].tolist()
    return {"A": a, "E": e, "form": "grid" if form else "first CTA"}


def level_dense(state: drk.DrainState):
    """(levels int32[N], rounds int32[]) by one cooperative launch and one
    allocation (the levels and rounds are views of its workspace).  The
    device runs the rounds in its first CTA where their state fits, else
    on the grid."""
    if not on_cuda(state.status):
        return drk.level_assign_dense_plain(state)
    buf, n, _words = _level_launch("level_dense", state, _level_values,
                                   False)
    return buf[:n], buf[n]


def level_drain_dense(state: drk.DrainState, watermark=None):
    """Dense-state analogue of :func:`level_drain_ell`: K7 dense's one
    launch with the level-drain epilogue."""
    if not on_cuda(state.status):
        return _drain_plain(drk.level_assign_dense_plain, state, watermark)
    return _drain_views(*_level_launch("level_dense", state, _level_values,
                                       True, watermark))


# -- K8: the fixpoint drains ---------------------------------------------------

def _square(state: drk.DrainState) -> int:
    n = state.status.shape[0]
    if state.adj.shape != (n, n):
        raise ValueError(f"adjacency {tuple(state.adj.shape)} is not "
                         f"[{n}, {n}]")
    return n


def _drain_outputs(dev, n: int):
    return (torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty((), dtype=torch.int32, device=dev))


def _fix_buffer(dev, words: int, n: int):
    """One allocation for K8 ELL: its workspace of ``words`` int32 words,
    and its outputs (applied bool[n], newly bool[n], sweeps int32[]) as
    views behind it, which keep it alive."""
    buf = torch.empty(words + 1 + -(-2 * n // 4), dtype=torch.int32,
                      device=dev)
    flags = buf[words + 1:].view(torch.bool)
    return buf[:words], (flags[:n], flags[n:2 * n], buf[words])


@functools.lru_cache(maxsize=64)
def _drain_fix_words(n: int) -> int:
    """The int32 words of the tile loader's workspace (K8 dense, K13), as
    its entry points lay it out."""
    return _build.library().accord_drain_fix_workspace_words(n)


@functools.lru_cache(maxsize=64)
def _drain_fix_ell_words(n: int, d: int) -> int:
    """The int32 words of K8 ELL's workspace, as its entry point lays it
    out."""
    return _build.library().accord_drain_fix_ell_workspace_words(n, d)


def drain_fix_dense(state: drk.DrainState):
    """(applied, newly, sweeps int32[]) by one cooperative launch (the
    frontier form of the fixpoint, ``csrc/drain_frontier.cuh``)."""
    if not on_cuda(state.status):
        return drk._drain_fix_plain(state)
    dev = state.status.device
    _check_cols(state)
    n = _square(state)
    words = _drain_fix_words(n)
    ws = torch.empty(words, dtype=torch.int32, device=dev)
    out = _drain_outputs(dev, n)
    _launch("drain_fix_dense", dev, [*state, ws, *out], [n, words])
    return out


def drain_fix_ell(state: drk.EllDrainState):
    """(applied, newly, sweeps int32[]) by one cooperative launch and one
    allocation (the frontier form of the fixpoint over the ELL edges)."""
    if not on_cuda(state.status):
        return drk._drain_ell_fix_plain(state)
    dev = state.status.device
    _check_cols(state)
    n, d = state.adj_idx.shape
    words = _drain_fix_ell_words(n, d)
    ws, out = _fix_buffer(dev, words, n)
    _launch("drain_fix_ell", dev, [*state, ws, *out], [n, d, words])
    return out


# -- K9: log-squaring ------------------------------------------------------

def logsq_dense(state: drk.DrainState):
    """(applied, newly, squarings int32[]) by one cooperative launch."""
    if not on_cuda(state.status):
        return drk.drain_dense_logsq_plain(state)
    dev = state.status.device
    _check_cols(state)
    n = _square(state)
    # one int32 workspace (``work`` of csrc/logsq.cu): s by rows and by
    # columns twice each (N padded to the 256-bit k-chunk), the targets,
    # the chunk masks, the tile counters, the flags and ``hit``
    npad = -(-n // 256) * 256
    w = npad // 32
    masks = 6 * (npad // 128) * -(-npad // 256 // 32)
    work = torch.empty(4 * npad * w + w + masks + 6 + -(-n // 4),
                       dtype=torch.int32, device=dev)
    out = _drain_outputs(dev, n)
    _launch("logsq_dense", dev, [*state, work, *out], [n])
    return out


# -- K10: dense -> ELL --------------------------------------------------------

def _square_adj(adj: torch.Tensor) -> int:
    _check(adj, torch.bool, "adj")
    n = adj.shape[0]
    if adj.shape != (n, n):
        raise ValueError(f"adjacency {tuple(adj.shape)} is not square")
    return n


def dense_degree(adj: torch.Tensor) -> torch.Tensor:
    """int32[]: the largest row degree."""
    if not on_cuda(adj):
        return drk._dense_degree_plain(adj)
    n = _square_adj(adj)
    out = torch.empty((), dtype=torch.int32, device=adj.device)
    _launch("dense_degree", adj.device, [adj, out], [n])
    return out


def dense_to_ell(adj: torch.Tensor, d: int) -> torch.Tensor:
    """int32[N, d]: each row's first d set columns ascending, then -1; one
    launch, one allocation (the output)."""
    if not on_cuda(adj):
        return drk.dense_to_ell_plain(adj, d)
    n = _square_adj(adj)
    if d < 1:
        raise ValueError(f"ELL width {d} < 1")
    if not adj.is_contiguous():
        raise ValueError("adj is not contiguous")
    out = torch.empty((n, d), dtype=torch.int32, device=adj.device)
    p = array("Q", (adj.data_ptr(), out.data_ptr()))
    v = array("q", (n, d))
    _launch_packed("dense_to_ell", adj.device.index,
                   _build.entries()["dense_to_ell"], p.buffer_info()[0],
                   v.buffer_info()[0])
    return out


# -- K11: calculate_deps and the lexicographic max ----------------------------

_QUERY_DTYPES = (_I64, _I64, _I32, _I32, _I64, _I64, _I64, _I64, _I32)


def _query_values(query: dk.DepsQuery, idx: int) -> list:
    """Each DepsQuery column's pointer and element strides, the launch
    values K11 reads the query batch by, where it lies on device index
    ``idx``: B rows each, lo and hi [B, m]."""
    b, m = query.lo.shape
    vals = []
    for i, (col, dt) in enumerate(zip(query, _QUERY_DTYPES)):
        shape = (b, m) if i in (4, 5) else (b,)
        if col.dtype is not dt or col.get_device() != idx \
                or col.shape != shape:
            raise TypeError(f"DepsQuery.{query._fields[i]}: expected {dt}"
                            f"{list(shape)} on cuda:{idx}, got {col.dtype}"
                            f"{list(col.shape)} on {col.device}")
        vals.append(col.data_ptr())
        vals.extend(col.stride())
    return vals


def _slice_cols(t: dk.DepsTable, idx: int) -> list:
    """A slot slice's column pointers, its dtypes, device index ``idx``
    and contiguity checked."""
    out = []
    for i, (col, dt) in enumerate(zip(t, _DTYPES[dk.DepsTable])):
        if col.dtype is not dt or col.get_device() != idx \
                or not col.is_contiguous():
            raise ValueError(f"DepsTable.{t._fields[i]}: expected a "
                             f"contiguous {dt} on cuda:{idx}")
        out.append(col.data_ptr())
    return out


# K11's last CTA of a slice folds its tiles' candidates, counting them on
# a word it sets back to zero: one word a slice of a launch, kept per
# (device, stream), since launches on one stream are ordered
_FOLD: Dict[tuple, torch.Tensor] = {}


def _fold_words(idx: int) -> int:
    """The address of the uint32 fold words of device index ``idx``'s
    current stream, zero between launches."""
    key = (idx, _raw_stream(idx) if _raw_stream is not None
           else torch.cuda.current_stream(idx).cuda_stream)
    w = _FOLD.get(key)
    if w is None:
        w = _FOLD[key] = torch.zeros(SHARDED_MAX_SLICES, dtype=torch.int32,
                                     device=torch.device("cuda", idx))
    return w.data_ptr()


@functools.lru_cache(maxsize=256)
def _calc_tiles(n: int) -> int:
    """The CTAs (slot tiles) K11 takes for a slice of ``n`` slots."""
    return _build.library().accord_calc_tiles(n)


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def calc_deps(tables: Sequence[dk.DepsTable], query: dk.DepsQuery,
              prune=None):
    """The dense dep mask and max-conflict of every slot slice in
    ``tables`` (all on one device): (masks [bool[B, n_i]], (msb, lsb,
    node) [S, B]).  One launch for up to ``SHARDED_MAX_SLICES`` slices,
    their columns and the query's by value; the masks, the tiles'
    candidates and the outputs are one allocation."""
    if not on_cuda(query.msb):
        return dk.calc_deps_plain(tables, query, prune)
    dev = query.msb.device
    idx = dev.index
    b, m = query.lo.shape
    m_t = tables[0].lo.shape[1]
    n_s = len(tables)
    qv = _query_values(query, idx)
    cols = []
    for t in tables:
        if t.lo.shape[1] != m_t:
            raise ValueError("calc_deps: slices differ in interval width")
        cols.append(_slice_cols(t, idx))
    ns = [t.msb.shape[0] for t in tables]
    # the masks at 16-byte offsets, then the candidates [S, B, T] of the
    # largest launch (msb, lsb int64, node int32, valid uint8), then the
    # outputs (msb, lsb int64 [S, B], node int32 [S, B])
    offs, at = [], 0
    for n in ns:
        offs.append(at)
        at = _align(at + b * n, 16)
    n_l = min(n_s, SHARDED_MAX_SLICES)
    cand = at
    at = _align(cand + 21 * n_l * b * max(map(_calc_tiles, ns)), 8)
    nb = n_s * b
    buf = torch.empty(at + _align(20 * nb, 8), dtype=torch.bool, device=dev)
    masks = [buf.as_strided((b, n), (n, 1), o) for o, n in zip(offs, ns)]
    out = buf[at:].view(torch.int64)
    om = out[:nb].view(n_s, b)
    ol = out[nb:2 * nb].view(n_s, b)
    on = out[2 * nb:].view(torch.int32)[:nb].view(n_s, b)
    base = buf.data_ptr()
    o0 = base + at
    fold = _fold_words(idx)
    pm, pl, pn = _prune_vals(prune)
    for i0 in range(0, n_s, SHARDED_MAX_SLICES):
        i1 = min(i0 + SHARDED_MAX_SLICES, n_s)
        v = array("q", [i1 - i0, b, m, m_t, pm, pl, pn, *qv])
        for i in range(i0, i1):
            v.extend(cols[i])
            v.append(base + offs[i])
            v.append(ns[i])
        _launch("calc_deps", dev,
                [base + cand, o0 + 8 * i0 * b, o0 + 8 * (nb + i0 * b),
                 o0 + 16 * nb + 4 * i0 * b, fold], v)
    return masks, (om, ol, on)


def ts_max(msb: torch.Tensor, lsb: torch.Tensor, node: torch.Tensor):
    """Lexicographic max over the first axis of [C, R] candidates, a
    candidate counting when any of its fields is non-zero: (msb, lsb,
    node) [R], one allocation."""
    if not on_cuda(msb):
        return dk.ts_max_plain(msb, lsb, node)
    dev = msb.device
    c, r = msb.shape
    if msb.dtype is not _I64 or lsb.dtype is not _I64 \
            or node.dtype is not _I32:
        raise TypeError("ts_max: expected int64 msb and lsb, int32 node")
    if lsb.shape != (c, r) or node.shape != (c, r):
        raise ValueError("ts_max: the candidate fields differ in shape")
    buf = torch.empty(2 * r + (r + 1) // 2, dtype=torch.int64, device=dev)
    o = buf.data_ptr()
    _launch("ts_max", dev, [msb.contiguous(), lsb.contiguous(),
                            node.contiguous(), o, o + 8 * r, o + 16 * r],
            [r, c, 1, r])
    return buf[:r], buf[r:2 * r], buf[2 * r:].view(torch.int32)[:r]


# -- K12: the cross-shard merge ------------------------------------------------

# blocks a K12 launch takes by value (MAX_REFS of csrc/merge.cu): (header,
# entries, offset) of each of S x d blocks travel in the kernel parameter;
# a larger call uploads them as a table
MERGE_MAX_REFS = _build.LIMITS["ACCORD_MERGE_MAX_REFS"]


@functools.lru_cache(maxsize=64)
def _merge_workspace_words(n_s: int, d: int, s: int, b: int) -> int:
    """The int64 words of K12's workspace, as its entry point lays it out."""
    return _build.library().accord_merge_workspace_words(n_s, d, s, b)


def merge_blocks(blocks, b: int, s: int, codespace: int,
                 dedupe_key_m: int = 0, dom: torch.Tensor = None,
                 mq: int = None):
    """Merge each store's d attributed shard blocks into one: ``blocks``
    is [store][shard] of (header int32[5+B], entries[s], code offset), all
    on one device.  Returns (header int32[S, 5+B], entries [S, d*s])."""
    hdr0, ent0, _off = blocks[0][0]
    if not on_cuda(ent0):
        from ..parallel.sharded import merge_blocks_plain
        return merge_blocks_plain(blocks, b, s, codespace, dedupe_key_m,
                                  dom, mq)
    dev = ent0.device
    n_s, d = len(blocks), len(blocks[0])
    refs = []
    hshape, eshape, edt = (5 + b,), (s,), ent0.dtype
    for blk in blocks:
        if len(blk) != d:
            raise ValueError("merge_blocks: stores differ in shard count")
        for h, e, off in blk:
            if h.dtype is not torch.int32 or e.dtype is not edt \
                    or h.shape != hshape or e.shape != eshape:
                raise ValueError("merge_blocks: a block does not fit "
                                 f"int32[5+{b}] / {edt}[{s}]")
            refs += (_ptr(h), _ptr(e), off)
    if dedupe_key_m:
        _check(dom, torch.int32, "dom")
    words = _merge_workspace_words(n_s, d, s, b)
    ws = torch.empty(words, dtype=torch.int64, device=dev)
    hdr = torch.empty((n_s, 5 + b), dtype=torch.int32, device=dev)
    out = torch.empty((n_s, d * s), dtype=edt, device=dev)
    vals = [n_s, d, s, b, codespace, dedupe_key_m, mq or 1,
            dom.shape[0] if dedupe_key_m else 1,
            int(ent0.dtype == torch.int64), words]
    table = None
    if n_s * d > MERGE_MAX_REFS:
        table = torch.from_numpy(np.asarray(refs, np.int64)).to(dev)
    else:
        vals += refs
    _launch("merge_blocks", dev,
            [table, dom if dedupe_key_m else None, ws, hdr, out], vals)
    return hdr, out


# -- K13: the row-sharded frontier, fixpoint sweep and fixpoint drain --------

# slices a K13 launch takes (MAX_SLICES of csrc/sharded_frontier.cu): they
# travel by value in the kernel parameter, so nothing is uploaded
SHARDED_MAX_SLICES = _build.LIMITS["ACCORD_SHARDED_MAX_SLICES"]


def _slice_ptrs(rows, cols, n_l: int, n: int, drain: bool) -> list:
    """The 8 tensors per slice that K13 reads (``read_slices`` of
    csrc/sharded_frontier.cu): a swept slice's adjacency, awaits and out,
    every slice's column arrays.  A swept row reads its own status and
    executeAt from its slice's column arrays, so they must be the same
    tensors."""
    d = len(cols)
    if d > SHARDED_MAX_SLICES:
        raise ValueError(f"K13 takes at most {SHARDED_MAX_SLICES} slices, "
                         f"got {d}")
    swept = {}
    for adj, status, em, el, en, aw, applied, out, idx in rows:
        col = cols[idx]
        if (col[0] is not status or col[1] is not em or col[2] is not el
                or col[3] is not en or (drain and col[4] is not applied)):
            raise ValueError(f"slice {idx}: its row arrays are not its "
                             "column arrays")
        _check(adj, torch.bool, "adj")
        if adj.shape != (n_l, n):
            raise ValueError(f"slice adjacency {tuple(adj.shape)} is not "
                             f"[{n_l}, {n}]")
        swept[idx] = (adj, aw, out)
    ptrs = []
    for k, (status, em, el, en, applied) in enumerate(cols):
        _check(status, torch.int32, "status")
        adj, aw, out = swept.get(k, (None, None, None))
        ptrs += [adj, aw, status, em, el, en, applied, out]
    return ptrs


def _sweep(name: str, rows, cols, n_l: int, n: int, drain: bool):
    dev = rows[0][1].device
    changed = torch.empty(1, dtype=torch.int32, device=dev)
    idx = [r[8] for r in rows]
    _launch(name, dev, _slice_ptrs(rows, cols, n_l, n, drain) + [changed],
            [len(cols), n_l, n, int(drain), len(idx), *idx],
            entry="sharded_sweep")
    return changed


def sharded_frontier(rows, cols, n_l: int, n: int) -> None:
    """One frontier sweep over the row slices ``rows`` of one device:
    each row is (adj, status, emsb, elsb, enode, awaits, None, out,
    slice index); ``cols`` holds every slice's (status, emsb, elsb, enode,
    None) on this device.  Writes each slice's ready flags to its out."""
    if not on_cuda(rows[0][1]):
        from ..parallel.sharded import sweep_plain
        sweep_plain(rows, cols, n_l, drain=False)
        return
    _sweep("sharded_frontier", rows, cols, n_l, n, drain=False)


def sharded_drain(rows, cols, n_l: int, n: int) -> torch.Tensor:
    """One fixpoint sweep: as sharded_frontier, with each row's and
    column's applied flags (the previous sweep's) in the applied slots;
    writes applied | ready to each out.  Returns int32[1], non-zero when a
    row became ready."""
    if not on_cuda(rows[0][1]):
        from ..parallel.sharded import sweep_plain
        return sweep_plain(rows, cols, n_l, drain=True)
    return _sweep("sharded_drain", rows, cols, n_l, n, drain=True)


def sharded_drain_fix(rows, cols, n_l: int, n: int) -> torch.Tensor:
    """The whole row-sharded fixpoint drain in one cooperative launch,
    every slice on one device: ``rows`` holds every slice as in
    sharded_frontier (applied None), ``cols`` every slice's column arrays
    (applied None).  Writes each slice's final applied flags to its out;
    returns the sweep count int32[1] (the final empty sweep included)."""
    if not on_cuda(rows[0][1]):
        from ..parallel.sharded import drain_fix_plain
        return drain_fix_plain(rows, cols, n_l)
    dev = rows[0][1].device
    d = len(cols)
    if sorted(r[8] for r in rows) != list(range(d)):
        raise ValueError("sharded_drain_fix sweeps every slice in one "
                         "launch")
    words = _drain_fix_words(n)
    buf = torch.empty(words + 1, dtype=torch.int32, device=dev)
    _launch("sharded_drain_fix", dev,
            _slice_ptrs(rows, cols, n_l, n, False)
            + [buf[:words], buf[words:]], [d, n_l, n, words])
    return buf[words:]


# -- K2 extension: the mesh-bucketed entry tokens ------------------------------

# pointers an attr_tok launch takes by value (TOK_REFS of
# csrc/attr_post.cu): every slice's lo, then its rows' entries; more rows
# than fit take more launches
TOK_MAX_REFS = _build.LIMITS["ACCORD_TOK_MAX_REFS"]
# the lo pointers of the last slice set each device took, with weak
# references to its tensors: an unchanged set (the mirror's sharded table,
# kept until it mutates) is not checked again
_TOK_LOS: Dict[int, tuple] = {}


def _tok_los(los, idx: int, sn: int, m_t: int) -> array:
    """The lo pointers of ``los`` (0 for a slice elsewhere), each lo an
    int64[sn, m_t], contiguous, on device index ``idx``."""
    got = _TOK_LOS.get(idx)
    if got is not None and got[2] == (sn, m_t) and len(got[0]) == len(los) \
            and all(lo is None if w is None else w() is lo
                    for w, lo in zip(got[0], los)):
        return got[1]
    ptrs = array("q")
    for o, lo in enumerate(los):
        if lo is not None and (lo.dtype is not torch.int64
                               or lo.get_device() != idx
                               or lo.shape != (sn, m_t)
                               or not lo.is_contiguous()):
            raise ValueError(f"attr_tok: slice {o}'s lo is not a contiguous "
                             f"int64[{sn}, {m_t}] on cuda:{idx}")
        ptrs.append(0 if lo is None else lo.data_ptr())
    _TOK_LOS[idx] = ([None if lo is None else weakref.ref(lo) for lo in los],
                     ptrs, (sn, m_t))
    return ptrs


def attr_tok(ents: Sequence[torch.Tensor], los, sn: int, m_t: int, m: int):
    """int64[d, s]: the token lo[slot, col] of every shard's entry, from
    the slices in ``los`` (a slice's lo on this device, or None when it
    lies elsewhere: its terms are 0 here and come from its own device).
    Every pointer travels by value: each launch takes every slice's lo
    and up to ``TOK_MAX_REFS - d`` rows of entries; one allocation."""
    if not on_cuda(ents[0]):
        from ..parallel.sharded import attr_tok_plain
        return attr_tok_plain(ents, los, sn, m_t, m)
    dev = ents[0].device
    idx = dev.index
    d, s = len(ents), ents[0].shape[0]
    if len(los) != d or d >= TOK_MAX_REFS:
        raise ValueError(f"attr_tok: {d} shards, {len(los)} slices (at most "
                         f"{TOK_MAX_REFS - 1})")
    lo_ptrs = _tok_los(los, idx, sn, m_t)
    dt = ents[0].dtype
    if dt is not torch.int32 and dt is not torch.int64:
        raise TypeError(f"attr_tok: entries of {dt}")
    ent_ptrs = array("q")
    for e in ents:
        if e.dtype is not dt or e.get_device() != idx or e.shape != (s,) \
                or not e.is_contiguous():
            raise ValueError(f"attr_tok: every shard's entries must be a "
                             f"contiguous {dt}[{s}] on cuda:{idx}")
        ent_ptrs.append(e.data_ptr())
    tok = torch.empty((d, s), dtype=torch.int64, device=dev)
    fn = _build.entries()["attr_tok"]
    per = TOK_MAX_REFS - d
    for r0 in range(0, d, per):
        rows = min(per, d - r0)
        v = array("q", (d, s, sn, m_t, m, int(dt is torch.int64), rows))
        v.extend(lo_ptrs)
        v.extend(ent_ptrs[r0:r0 + rows])
        p = array("Q", (tok.data_ptr() + 8 * r0 * s,))
        _launch_packed("attr_tok", idx, fn, p.buffer_info()[0],
                       v.buffer_info()[0])
    return tok
