#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``accord_tpu_torch``) on one NVIDIA
card.

    python3 chip_smoke.py                 # the card run (needs one CUDA card)
    python3 chip_smoke.py --cpu-rehearsal # control flow only, tiny, on the CPU

Phases:
  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit (nvidia-smi);
  2. build: every ``accord_tpu_torch/ops/csrc/*.cu`` with nvcc for sm_90a;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, byte-equal, on seeded inputs at a small size (the mesh kernels
     K11-K13, the token gather and the K1a / K2 extensions over an
     8-slice mesh of the card) and on the inputs the main path below
     gives it (the dense frontier's after phase 6, from the burn; the
     drain kernels' on phase 8's states; the mesh kernels' the largest
     of phases 9-11); median ms of kernel, plain version, library call
     (where one exists) and the least time the card could take (bound,
     from the bytes and operations this input needs).  K3 is held at P =
     1, 7, 8 and 4,097 rows on every scatter's columns, in its timed form
     (device tensors in) and its live form (numpy in: one packed upload),
     and timed in both at the largest recorded call and in the live form
     at 8 rows of the store's table; K12 over 1 to 17 stores of 1, 3 or
     8 blocks (under and over the blocks a launch takes by value), with
     and without the dedupe, with overflowed blocks; K1a at its design's
     edges (no valid candidate, merge-sorted rows, rows past SMEM_CODES,
     kk in a run of equal codes, s in a row, a row-sharded slice, more
     rows than CTAs) and K8 dense at N = 0 to 8,193 and either side of
     its handover; K8 ELL on the ELL forms of those graphs, either side of
     its own handover, on duplicate deps, -1 holes, dead deps, executeAt
     ties and a count past a byte, and at 100,000 and 120,000 rows (wide
     levels handed back to the grid, counts past the first CTA's shared
     memory); K13's one-launch drain on K8's handover graphs and a wide
     input, 8 slices; K1a also at the burn's median call, K8 dense and
     K8 ELL also on narrow-then-wide levels, K8 dense on a wide input,
     and the latency of one grid barrier, one block barrier and two
     dependent L2 reads
     (ops/csrc/probes.cu); K5 on the CPU
     tests' edge groups (members of 300, 40 and 96 FREE slots, unequal
     interval widths, a query interval over the whole line, B = 1 and 33,
     a kp cut inside a word, s and k overflowing), on two stores and on
     one store more than a launch takes by value, and at phase 7's
     recorded call and the burn's median (its bound on the operations
     each member's data needs); K4b planned at n = 200 and 1,000 (rows
     that end inside a 16-byte chunk) and timed at config 3's [4096,
     4096]; K11 on ragged slices (131,072 and 1,000 slots; 0 and 500),
     B = 1 and 129, a slice of dead slots, the prune floor, interval
     widths 1, 2, 3 and 8, and 17 slices (two launches); K6 dense on
     members of 1, 37, 100 and 17 rows (and into a pinned host buffer)
     and on 130 members (two launches), timed at phase 7's 2 x [4096,
     4096] (and on one planned group); K7 dense on more than 32 deps a
     row (at 4,096 rows past the lists' regions), a 300-row chain closed
     by an ``awaits_all`` cycle, 256 rows all blocked and a 1,024-row
     DAG at its first CTA's shared-memory cap, with the grid form pinned
     on phase 3's random inputs and the 1,024-deep chain, and timed on
     config 3's chain, an 8,192-deep chain (the grid form) and the cap's
     DAG, each form; K7 ELL either side of its first CTA's caps (a chain
     of 4,097 / 4,098 rows, 4,026 / 4,027 Stable rows of 8 deps), D = 1
     and D = 33, an ``awaits_all`` cycle, all blocked and 131,072 Stable
     rows (the grid form), each cap's form checked, and timed at phase
     5's and phase 8's states, the 131,072 rows, the 1,024-row chain and
     phase 3's random inputs, with each real input's Stable rows A, list
     entries E and form printed; K2's token gather (``attr_tok``) over
     40 shards (past what a launch takes by value: two launches), with
     slices on no device of the group (None), on int32 and int64 codes;
     the log-depth drains (K7's one launch with K9's level-drain
     epilogue; ``fused_k9``) on phase 3's inputs and the 1,024-row chain
     in both loaders, with no watermark, an int and 0-d int64 and int32
     tensors on the card, and timed at phase 8's 100k ELL rows (the grid
     form), phase 8's chain in ELL form and config 3's chain in dense
     form (the first CTA), an 8,192-deep chain (dense's grid form), phase
     3's random inputs and the watermark forms (131,072 Stable rows: ELL's
     grid form); K10's dense -> ELL at N = 1 to 4,097 (rows off a 16-byte
     chunk, a matrix that starts 7 bytes into one), d = 1, 4, 8 and 64,
     rows of 0, d - 1, d, d + 1 and N deps and a dep in a row's last byte,
     timed at config 3's chain and the router's probe (256 rows, d = 4),
     and through ``kernels._launch`` beside its wrapper; K4a at D = 1, 3,
     4, 8, 32, 33 and 64 on 300 rows (one to 16 chunks of a row's edges;
     every status, ``awaits_all`` rows, -1 edges mid-row), K6 ELL on
     members of unequal n and d (one of 0
     rows) and on 130 members (two launches), both into pinned and device
     ``out``; K4a timed at phase 5's [131072, 8] state and K6 ELL at phase
     7's 2 x [131072, 8], repeated and as the ticks pay for them (new
     states each call, into a pinned buffer, one synchronisation; a tree
     without ``out``: the launch and ``.cpu()``);
  4. the main path, a PreAccept deps store at real size: 100,000 in-flight
     txns over a 1,000,000-key space, up to 8 intervals each, with
     RedundantBefore floors and CommandsForKey state; 12,288 queries in
     batches of 2,048 through deps_query_batch_begin / end_attributed on
     the device route, plus live maintenance (registrations between
     batches); two batches' built Deps must equal the host route's;
  5. the main path's drain half at real size: a store with 100,000 live
     drain rows (degree <= 8), its Stable txns armed through
     DeviceState.arm; two drain ticks (ELL frontier on the card), the
     second after 2,000 applied dependencies, each proposing exactly the
     plain version's frontier.  Then the adaptive wavefront: a 4,096-deep
     serial chain (bench config 3's) armed among those rows, and the store
     applying what it is proposed; W doubles, the level pass (level_ell)
     harvests W antichains a tick, the chain applies in at most
     log2(4096) + 4 ticks, and everything applied equals the plain level
     pass.  The same chain alone takes the dense form (frontier_dense,
     level_dense);
  6. the protocol: ``run_burn(seed=1, n_ops=150)`` on the card in the
     default configuration (fused flushes and ticks as the pricing
     decides, the adaptive wavefront) with every store on the device
     route; the strict-serializability verifier passes, kernel flushes and
     device drain ticks happen, no host tick and no fault; a second run of
     the seed gives the same digest;
  7. fused launches: bench config 5's harness at its real shape (16 stores
     x 2,048 in-flight txns, 4,096 keys, 4-query flushes) on one
     DeviceDispatcher, fusion off then on over the same queries: per-store
     Deps equal, txn/s and launches per 1k txns for both, and the kernel
     launches of a fused flush the same for 16 and 4 stores; then one fused
     ELL tick over two 100,000-row drain stores and one fused dense tick
     over two small ones, each store's proposals equal to its plain
     frontier;
  8. hot keys: bench config 3 (``bench_hot_keys``) at its specified scale.
     The hot-128 store (100,000 txns over 128 keys, the 90% durable floor,
     update_status and CommandsForKey state), a learning pass and a timed
     4 x 256-query scan (prune_floors, attributed, pipelined two deep):
     deps_found must be 231,203, on the router's routes and again with the
     device route pinned.  The routed ELL drain over 100,000 Stable
     txns in 512 hot chains (first call log-depth, then priced by the
     card's probe; the fixpoint oracle runs 634 sweeps; all drain 100,000),
     against the host Kahn drain.  The 4,096-deep chain: the dense oracle
     runs 4,097 sweeps, the routed ELL drain (1 + 3 calls) and the ELL
     log-depth drain (13 rounds) give its bytes, drain_auto's three dense
     routes are each forced through set_drain_calibration and give its
     bytes, and both watermark forms at w in {0, 1, 2, 4096} equal w
     fixpoint sweeps.  Last, ACCORD_TPU_DRAIN=fixpoint pins both routed
     drains to the fixpoint and an injected kernel_launch fault fails the
     log-depth drain over with the same bytes;
  9. the mesh, bench config 4 (``config4_child``) at its specified scale
     on 8 slices of the card (the mesh is forced, whatever the machine
     shows): 20,000 txns over 64 shards of 4,096 keys, 512 attributed
     queries through the mesh-bucketed, mesh-dense, host and routed
     paths; every route builds the same Deps, the mesh bucketed kernels
     run; txn/s of each and the routes the router picks; then the mesh's
     fused forms (sharded_fused_flat, sharded_fused_attr: K5 a slice)
     on a seeded group, byte-equal to the same on CPU copies;
 10. store-sharded residency, bench config 5b (``bench_store_sharded``):
     one store walked up the budget ladder to 2^20 slots against a
     2^17-slot budget spills to 8 slices, not to the host; 128 pruned
     queries on the pinned dense route give the host oracle's CSR byte
     for byte; K11 over the resident slices at bool[128, 2^20] equals
     its plain version; a fault in slice 3 quarantines that slice only,
     and the hybrid flush gives the host route's Deps;
 11. the graft entries (``entry()`` on the card equals its plain run,
     ``dryrun_multichip(8)``), the row-sharded frontier and fixpoint
     drain on config 3's 4,096-deep chain against K4b and K8, and a store
     with the mesh on ticking until a mesh tick served.
After the main path, K4b is timed at the burn's largest dense tick in
repeated calls on one state (unplanned, as the burn records it, and
planned) and as the tick pays for it (a new state each call, its flags
written into a pinned host buffer, one stream synchronisation; planned
and not), beside an empty kernel launched through the same path
(``kernels._launch_packed``: the short-call floor), and phase 6 prints the median dispatch and wait of the second
burn's solo dense ticks; K6 dense is timed at the burn's median fused
group, repeated and as the fused tick pays for it (new states each call,
into a pinned buffer, one synchronisation), and two fused dense ticks
over disjoint stores are launched back to back and must each harvest
their own flags; K11 is timed at phase 10's recorded call
against the operations its data needs (``calc_needed_ops``) and the
formula's count.  Then a real CUDA error in a store's flush: every free
byte of the card is held while one dirty-row scatter allocates, so it
raises torch.OutOfMemoryError; the flush fails over to the host with a
twin store's bytes, one device fault, one quarantine, and the probe's
restore.  A real launch the library refuses for an invalid argument
(cudaErrorInvalidValue) must instead propagate, off the fault ladder.
Then torch.profiler counts the device operations of one K12 call (one
kernel), one live K3 call (one copy, one kernel) and K1a's, K1b's, K2's,
K4a's and K6 ELL's (repeated and in the ticks' forms; the most of three
traces), K4b's, K5's, K6 dense's, K7 dense's, K8's, K11's cross-slice reduce's
and K13's one-launch drain's calls (one kernel, no memset, no copy;
K5's, K6's, K7's, K8 ELL's, K13's and ``attr_tok``'s the most of three
traces), the log-depth drains' and K10's (one kernel, no memset, no copy;
the fused drain's device time against the levels-only launch's on the
same input is K9's epilogue) and
gives K11's and the empty kernel's device time,
times one whole fused flush at phase 7's recorded call (the host's
enqueue and wall time beside its CUDA-event time, device tensors in and
as the dispatcher uploads them), and traces two phase-4 batches and four
phase-7 rounds, solo and fused, for the device's busy share and its time
by kernel name.

The script runs on an earlier tree too (K4a and K6 ELL without ``out``:
their tick forms launch and download by ``.cpu()``, the ``out`` cases and
the one-kernel checks of the tick forms and K6 ELL are left out; K6
without ``out``, K7 without
``grid``: their tick form downloads by ``.cpu()``, the pinned checks and
forms are left out; K7 ELL without ``level_ell_stats`` and ``attr_tok``
without ``TOK_MAX_REFS``: no form, A or E printed, no launch-count or
one-kernel check of theirs; K9 as a launch of its own after K7's: each
log-depth drain is the K7 call and the K9 call, counted as launches, with
no one-kernel check), so that the parent and the change are timed by one
script.  The profiler runs only after the main path: a
trace taken before it lost the device records of later traces.

Every kernel launch count is set to 0 just before phases 4-11 and read
after each; each phase's seconds are printed: each kernel of the path must
have launched.  K9's epilogue has a count of its own
(``kernels.EPILOGUES``, the calls that ran it inside K7's launch): it must
have run in phase 8, and no standalone K9 launch may exist; its row in the
kernel table gives those calls as its launches, ``fused_into`` K7.  Phases 5 and 8 print what each of their K7 ELL calls
found (rows, A, E, form, rounds).  The second-to-last
lines carry the kernel table (JSON) and the card's name and power limit;
the last line is the result object.  Any failure exits non-zero without the
result line.  Long output (build log, profiler table, summary) goes to
``build/chip_smoke/``.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
from array import array
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

KMETA = {
    "deps_bucketed": ("accord_tpu_torch/ops/csrc/deps_scan.cu",
                      "accord_tpu/ops/deps_kernel.py:448"),
    "deps_dense": ("accord_tpu_torch/ops/csrc/deps_scan.cu",
                   "accord_tpu/ops/deps_kernel.py:351"),
    "attr_post": ("accord_tpu_torch/ops/csrc/attr_post.cu",
                  "accord_tpu/ops/deps_kernel.py:921"),
    "scatter_rows": ("accord_tpu_torch/ops/csrc/scatter_rows.cu",
                     "accord_tpu/ops/deps_kernel.py:156"),
    "frontier_ell": ("accord_tpu_torch/ops/csrc/frontier.cu",
                     "accord_tpu/ops/drain_kernel.py:173"),
    "frontier_dense": ("accord_tpu_torch/ops/csrc/frontier.cu",
                       "accord_tpu/ops/drain_kernel.py:133"),
    "fused_deps_dense": ("accord_tpu_torch/ops/csrc/fused_scan.cu",
                         "accord_tpu/ops/deps_kernel.py:605"),
    "fused_attr_post": ("accord_tpu_torch/ops/csrc/fused_scan.cu",
                        "accord_tpu/ops/deps_kernel.py:1081"),
    "fused_frontier_ell": ("accord_tpu_torch/ops/csrc/frontier.cu",
                           "accord_tpu/ops/drain_kernel.py:244"),
    "fused_frontier_dense": ("accord_tpu_torch/ops/csrc/frontier.cu",
                             "accord_tpu/ops/drain_kernel.py:214"),
    "level_ell": ("accord_tpu_torch/ops/csrc/levels.cu",
                  "accord_tpu/ops/drain_kernel.py:397"),
    "level_dense": ("accord_tpu_torch/ops/csrc/levels.cu",
                    "accord_tpu/ops/drain_kernel.py:421"),
    "drain_fix_dense": ("accord_tpu_torch/ops/csrc/drain_fix.cu",
                        "accord_tpu/ops/drain_kernel.py:126"),
    "drain_fix_ell": ("accord_tpu_torch/ops/csrc/drain_fix.cu",
                      "accord_tpu/ops/drain_kernel.py:300"),
    # K9's level-drain epilogue: inside K7's launch (levels.cu); a
    # launch of its own in logsq.cu on a tree before the fused form
    "level_drain": ("accord_tpu_torch/ops/csrc/levels.cu",
                    "accord_tpu/ops/drain_kernel.py:427"),
    "logsq_dense": ("accord_tpu_torch/ops/csrc/logsq.cu",
                    "accord_tpu/ops/drain_kernel.py:489"),
    "dense_degree": ("accord_tpu_torch/ops/csrc/dense_to_ell.cu",
                     "accord_tpu/ops/drain_kernel.py:524"),
    "dense_to_ell": ("accord_tpu_torch/ops/csrc/dense_to_ell.cu",
                     "accord_tpu/ops/drain_kernel.py:539"),
    "calc_deps": ("accord_tpu_torch/ops/csrc/calc_deps.cu",
                  "accord_tpu/ops/deps_kernel.py:217"),
    "ts_max": ("accord_tpu_torch/ops/csrc/calc_deps.cu",
               "accord_tpu/ops/packing.py:84"),
    "merge_blocks": ("accord_tpu_torch/ops/csrc/merge.cu",
                     "accord_tpu/parallel/sharded.py:425"),
    "sharded_frontier": ("accord_tpu_torch/ops/csrc/sharded_frontier.cu",
                         "accord_tpu/parallel/sharded.py:174"),
    "sharded_drain": ("accord_tpu_torch/ops/csrc/sharded_frontier.cu",
                      "accord_tpu/parallel/sharded.py:124"),
    "sharded_drain_fix": ("accord_tpu_torch/ops/csrc/sharded_frontier.cu",
                          "accord_tpu/parallel/sharded.py:124"),
    "attr_tok": ("accord_tpu_torch/ops/csrc/attr_post.cu",
                 "accord_tpu/parallel/sharded.py:566"),
}
MESH_KERNELS = ("calc_deps", "ts_max", "merge_blocks", "sharded_frontier",
                "sharded_drain", "sharded_drain_fix", "attr_tok")
# the per-sweep K13 drain runs only for a mesh whose slices span cards;
# every mesh here lies on one card, so the main path never launches it
# (its kernel is still held against its plain version below)
MULTI_CARD_ONLY = ("sharded_drain",)
# the queued device work a timed fused flush comes behind (about 0.1 ms of
# torch.cuda._sleep on an H100)
FLUSH_BUSY_CYCLES = 200_000
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and the dense
# int8 tensor-core rate, the stand-in for K9's b1 products (no b1 rate is
# published)
HBM_BPS = 3.35e12
# the host-to-device link of the SXM part: PCIe Gen5 x16, 128 GB/s both
# ways on NVIDIA's H100 data sheet, so 64 GB/s each way; it bounds a call
# that must upload its inputs (K3's live form)
PCIE_BPS = 64e9
TENSOR_INT8_OPS = 1979e12
# the peak of the scalar integer work (compares, selects, AND/OR): 32-bit
# integer instructions per second, 64 INT32 lanes an SM at the card's
# maximum SM clock (logic_rate); a CPU rehearsal uses 132 SMs x 1.98 GHz
LOGIC_OPS = 132 * 64 * 1.98e9
# the digest of phase 6's burn (seed 1, 150 ops) on the card: a kernel
# that changed a count the protocol sees would change it
BURN_DIGEST = "63002a1ae0c60636"
# the (unread) argument arrays of the empty kernel's launch
FLOOR_ARGS = array("q", [0])


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 -------------------------------------------------------------------

def environment(torch, rehearsal: bool) -> dict:
    smi = "not measured"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        if not rehearsal:
            fail("nvidia-smi did not report the card")
    nvcc = "not found"
    try:
        from accord_tpu_torch.ops import _build
        out = subprocess.run([_build._nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60)
        nvcc = [ln for ln in out.stdout.splitlines() if "release" in ln][0]
    except (RuntimeError, OSError, IndexError, subprocess.SubprocessError):
        if not rehearsal:
            fail("nvcc not found")
    env = {"python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "device": (torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else "cpu"),
           "nvidia_smi": smi, "nvcc": nvcc}
    try:
        import triton
        env["triton"] = triton.__version__
    except ImportError:
        env["triton"] = None
    log("env: " + json.dumps(env))
    return env


# -- seeded small inputs (the CPU tests' shapes) -------------------------------

WORDS = np.array([0, 1, (1 << 16) - 1, (1 << 47), (1 << 48) - 1, (1 << 62),
                  np.iinfo(np.int64).max, np.iinfo(np.int64).min, -1],
                 np.int64)


def _ids(rng, n):
    msb = np.where(rng.random(n) < 0.3, rng.choice(WORDS, n),
                   rng.integers(0, 8, n)).astype(np.int64)
    lsb = np.where(rng.random(n) < 0.3, rng.choice(WORDS, n),
                   rng.integers(0, 8, n)).astype(np.int64)
    return msb, lsb, rng.integers(-1, 4, n).astype(np.int32)


def small_inputs(seed, dk, n=256, m_t=4, m=4, b=32, g=32, kb=16, w=16,
                 space=300):
    """Seeded table / buckets / queries / attribution index."""
    from accord_tpu_torch.local.device_index import _AttrIndexHost
    rng = np.random.default_rng(seed)
    msb, lsb, node = _ids(rng, n)
    kind = rng.integers(0, 6, n).astype(np.int32)
    status = rng.integers(-1, 7, n).astype(np.int32)

    def intervals(rows, cols, fill):
        lo = np.full((rows, cols), dk.PAD_LO, np.int64)
        hi = np.full((rows, cols), dk.PAD_HI, np.int64)
        for i in range(rows):
            for c in range(int(rng.integers(0 if fill else 1, cols + 1))):
                a = int(rng.integers(0, space))
                wd = 0 if rng.random() < 0.6 else int(rng.integers(1, 40))
                lo[i, c], hi[i, c] = a, a + wd
        return lo, hi

    lo, hi = intervals(n, m_t, False)

    used = (lo <= hi).sum(axis=1)

    def entries(shape):
        slot = rng.integers(-1, n, shape).astype(np.int32)
        s = np.clip(slot, 0, None)
        col = (rng.random(shape) * used[s]).astype(np.int32)
        elo, ehi = lo[s, col], hi[s, col]
        pad = (slot < 0) | (elo > ehi)
        return (np.where(pad, dk.PAD_LO, elo), np.where(pad, dk.PAD_HI, ehi),
                np.where(pad, -1, slot).astype(np.int32),
                np.where(pad, 0, col).astype(np.int32), msb[s], lsb[s],
                node[s], kind[s])

    buckets = entries((g, kb)) + entries((w,))
    qmat = np.zeros((b, 7 + 2 * m), np.int64)
    bm, bl, bn = _ids(rng, b)
    pick = rng.integers(0, n, b)
    same = rng.random(b) < 0.4
    qmat[:, 0] = np.where(same, msb[pick], bm)
    qmat[:, 1] = np.where(same, lsb[pick], bl)
    qmat[:, 2] = np.where(same, node[pick], bn)
    qmat[:, 3] = rng.integers(0, 1 << 6, b)
    qmat[:, 4], qmat[:, 5], qmat[:, 6] = msb[pick], lsb[pick], node[pick]
    qlo, qhi = intervals(b, m, True)
    qmat[:, 7:7 + m], qmat[:, 7 + m:] = qlo, qhi
    qmat_b = np.concatenate(
        [qmat, rng.integers(-1, g, (b, m * 4)).astype(np.int64)], axis=1)
    em, el, en = _ids(rng, n)
    attr = (rng.integers(0, 2, n).astype(np.int32), status, msb, lsb, node,
            em, el, en, rng.random(n) < 0.7)
    fbnd = np.unique(rng.integers(0, space, 5)).astype(np.int64)
    fm = rng.integers(0, 2, len(fbnd) + 1).astype(np.int64)
    fl = rng.integers(0, 4, len(fbnd) + 1).astype(np.int64)
    fn = np.ones(len(fbnd) + 1, np.int32)
    toks = np.unique(rng.choice(lo[lo != dk.PAD_LO], 48)).astype(np.int64)
    lens = rng.integers(1, 4, len(toks))
    eptr = np.zeros(len(toks) + 1, np.int32)
    np.cumsum(lens, out=eptr[1:])
    xm, xl, xn = _ids(rng, int(lens.sum()))
    for t in range(len(toks)):
        sl = slice(eptr[t], eptr[t + 1])
        keys = list(zip(xm[sl].astype(np.uint64), xl[sl].astype(np.uint64),
                        xn[sl]))
        o = sorted(range(len(keys)), key=lambda i: keys[i])
        xm[sl], xl[sl], xn[sl] = xm[sl][o], xl[sl][o], xn[sl][o]
    host = _AttrIndexHost((fbnd, fm, fl, fn), toks, eptr, xm, xl, xn)
    return dict(table=(msb, lsb, node, kind, status, lo, hi),
                buckets=buckets, qmat=qmat, qmat_b=qmat_b, attr=attr,
                aidx=host.pad, rankb=host.rank_bounds(qmat), m=m, m_t=m_t,
                prune=(int(rng.integers(0, 3)), int(rng.integers(0, 4)), 1))


def small_drain(seed, n):
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), bool)
    for i in range(1, n):
        for _ in range(int(rng.integers(0, 4))):
            adj[i, int(rng.integers(0, i))] = True
    for _ in range(4):
        a, c = rng.integers(0, n, 2)
        if a != c:
            adj[a, c] = True
    status = rng.choice(np.array([-1, 0, 1, 2, 3, 4, 4, 4, 5, 5, 6],
                                 np.int32), n)
    msb = rng.integers(0, 6, n).astype(np.int64)
    lsb = np.where(rng.random(n) < 0.2, rng.choice(WORDS, n),
                   0).astype(np.int64)
    node = rng.integers(1, 3, n).astype(np.int32)
    awaits = rng.random(n) < 0.15
    idx = np.full((n, 8), -1, np.int32)
    for i in range(n):
        cols = np.nonzero(adj[i])[0][:8]
        idx[i, :len(cols)] = cols
    return (adj, status, msb, lsb, node, awaits), (idx, status, msb, lsb,
                                                    node, awaits)


def odd_ell(seed, n, d):
    """An ELL drain state of ``n`` rows and degree ``d`` for K4a and K6
    ELL (the CPU tests' ``_ell_case``): every status, ``awaits_all``
    rows, executeAt ties and -1 edges anywhere in a row; a third of the
    rows depend only on applied, invalidated or free slots, and a third
    also on decided slots that execute after them, so that rows of every
    degree are ready."""
    rng = np.random.default_rng(seed)
    status = rng.choice(np.array([-1, 0, 1, 2, 3, 4, 4, 4, 5, 5, 6],
                                 np.int32), n)
    msb = rng.integers(0, 4, n).astype(np.int64)
    lsb = np.where(rng.random(n) < 0.1, rng.choice(WORDS, n),
                   rng.integers(0, 2, n)).astype(np.int64)
    node = rng.integers(1, 3, n).astype(np.int32)
    awaits = rng.random(n) < 0.15
    done = np.nonzero(np.isin(status, (-1, 5, 6)))[0]
    idx = rng.integers(0, n, (n, d)).astype(np.int32)
    for i in range(n):
        kind = i % 3
        if kind and len(done):
            idx[i] = rng.choice(done, d)
        if kind == 2:
            later = np.nonzero((status >= 3) & (status <= 4)
                               & (msb > msb[i]))[0]
            if len(later):
                k = rng.integers(0, d + 1)
                idx[i, :k] = rng.choice(later, k)
                rng.shuffle(idx[i])
    idx[rng.random((n, d)) < 0.2] = -1
    return idx, status, msb, lsb, node, awaits


# -- the kernel checks ---------------------------------------------------------

def _max_abs_err(torch, a, b) -> int:
    if torch.is_tensor(a):
        a, b = (a,), (b,)
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            return -1
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                               .abs().max()))
    return err


def _diff_report(torch, a, b) -> str:
    """Where two outputs differ: per tensor, the count of differing
    positions and the first few (position, kernel, plain)."""
    if torch.is_tensor(a):
        a, b = (a,), (b,)
    out = []
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape or x.dtype != y.dtype:
            out.append(f"[{i}] {tuple(x.shape)} {x.dtype} vs "
                       f"{tuple(y.shape)} {y.dtype}")
            continue
        d = torch.nonzero((x != y).reshape(-1)).reshape(-1)
        if d.numel():
            xs, ys = x.reshape(-1), y.reshape(-1)
            first = [(int(p), int(xs[p]), int(ys[p])) for p in d[:6]]
            out.append(f"[{i}] {d.numel()} of {x.numel()} differ: {first}")
    return "; ".join(out)


def bucket_case(torch, kern, dk, m_t, buckets, qmat, m, span, s, k, prune,
                keff, wide, row_offset=None):
    b = qmat.shape[0]
    kb = buckets.blo.shape[1]
    keff_ = kb if keff is None else min(keff, kb)
    w = buckets.wlo.shape[0]
    c = m * span * keff_ + m * w
    cs = 8 if wide else 4
    rows = qmat[:, 7 + 2 * m:]
    touched = int(torch.unique(rows[rows >= 0]).numel())
    nbytes = (qmat.numel() * 8 + touched * keff_ * 48 + w * 48
              + (2 + b) * 4 + s * cs)
    ops = b * c * 12
    return (lambda: kern.deps_bucketed(m_t, buckets, qmat, m, span, s, k,
                                       prune, keff, wide, row_offset),
            lambda: dk.bucketed_flat_plain(m_t, buckets, qmat, m, span, s, k,
                                           prune, keff, wide, row_offset),
            None, nbytes, ops)


def bucket_edge_cases(torch, kern, dk, convert, dev) -> dict:
    """K1a at the edges of its design, the CPU tests' (narrow and wide
    codes each): no valid candidate (nv0); rows of more than 32 codes,
    merge-sorted in shared memory (merge); kk cutting a run of equal codes
    (every probe of a row on one bucket line, k = 2); s inside a row; the
    upper half of the bucket rows as a row-sharded slice (row_offset); and
    1,200 rows, more than the CTAs a launch holds (grid-stride rows)."""
    cases = {}
    for i, (tag, shape, keff) in enumerate((
            ("nv0", {}, 8), ("merge", dict(m=8, kb=32, space=40), 32),
            ("kk_in_dup_run", {}, 8), ("s_in_row", {}, 8),
            ("row_offset", {}, 8),
            ("b1200", dict(b=1200, m=8, kb=32, space=400), 32))):
        inp = small_inputs(60 + i, dk, **shape)
        buckets, qb = inp["buckets"], inp["qmat_b"].copy()
        m, prune, roff, s, k = inp["m"], inp["prune"], None, 8192, 64
        if tag == "nv0":
            prune = (-1, -1, 3)
        if tag == "row_offset":
            roff = buckets[0].shape[0] // 2
            buckets = tuple(c[roff:] for c in buckets[:8]) + buckets[8:]
        up = convert.tables_from_numpy({"buckets": buckets}, dev)["buckets"]
        if tag == "kk_in_dup_run":
            g = buckets[0].shape[0]
            tries = np.repeat(qb, g, axis=0)
            tries[:, 7 + 2 * m:] = np.tile(np.arange(g), len(qb))[:, None]
            pred, cand = dk.bucket_candidates(
                inp["m_t"], up, torch.from_numpy(tries).to(dev), m, 4, prune,
                keff)
            uniq = [len(set(c[p].tolist())) for p, c in zip(pred, cand)]
            qb[1] = tries[int(np.argmax(uniq))]
            k = 2
        qmat = torch.from_numpy(qb).to(dev)
        if tag == "s_in_row":
            hdr, _e = dk.bucketed_flat_plain(inp["m_t"], up, qmat, m, 4, s,
                                             k, prune, keff)
            ends = hdr[2:].to(torch.int64)
            sizes = torch.diff(ends, prepend=ends.new_zeros(1))
            r = int(torch.argmax((sizes >= 2).to(torch.int32)))
            s = int(ends[r] - sizes[r]) + 1     # one entry into a row of 2+
        for wide in (False, True):
            cases[f"deps_bucketed[{tag}{' i64' if wide else ''}]"] = \
                bucket_case(torch, kern, dk, inp["m_t"], up, qmat, m, 4, s,
                            k, prune, keff, wide, roff)
    return cases


def dense_needed_ops(torch, dk, table, qmat, m, s, k, prune) -> int:
    """The operations K1b's inputs need, counted with torch on their
    device: per slot its live and floor tests (6) and its span (2 m_t);
    per row its span (2 m); per (row, live slot) the scalar tests
    (witness, earlier, not self: 12); per pair that passes them the span
    test (2); per query interval of a pair whose spans meet its span test
    (2); per (query interval, slot interval) pair that test leaves, the
    overlap test (2); and 1 for each triple written.  The exact span
    filters of csrc/dense_tile.cuh skip every other interval pair, which
    the formula b n (2 m m_t + 12) counts."""
    b = qmat.shape[0]
    n, m_t = table.lo.shape
    q = dk.query_from_qmat(qmat, m)
    pm, pl, pn = dk._prune_tensors(prune, table.msb.device)
    ok = ((table.status >= dk.SLOT_TRANSITIVE)
          & (table.status != dk.SLOT_INVALIDATED)
          & ~dk.ts_lt(table.msb, table.lsb, table.node, pm, pl, pn))
    slo = table.lo.min(dim=1).values
    shi = table.hi.max(dim=1).values
    ops = n * (6 + 2 * m_t) + b * 2 * m + 12 * b * int(ok.sum())
    kp = min(k, n)
    kk = min(k, kp * m_t * m)
    written = 0
    t = [c[None, :] for c in (table.msb, table.lsb, table.node)]
    step = max(1, (1 << 26) // max(n * m * m_t, 1))
    for r0 in range(0, b, step):
        r = slice(r0, min(r0 + step, b))
        qlo, qhi = q.lo[r], q.hi[r]
        adm = (ok[None, :]
               & (((q.witness_mask[r, None] >> table.kind[None, :]) & 1) > 0)
               & dk.ts_lt(*t, q.msb[r, None], q.lsb[r, None],
                          q.node[r, None])
               & ~dk.ts_eq(*t, q.self_msb[r, None], q.self_lsb[r, None],
                           q.self_node[r, None]))
        meet = (adm & (qlo.min(dim=1).values[:, None] <= shi[None, :])
                & (slo[None, :] <= qhi.max(dim=1).values[:, None]))
        qmeet = (meet[:, :, None] & (qlo[:, None, :] <= shi[None, :, None])
                 & (slo[None, :, None] <= qhi[:, None, :]))
        tri = ((qlo[:, None, :, None] <= table.hi[None, :, None, :])
               & (table.lo[None, :, None, :] <= qhi[:, None, :, None])
               & qmeet[..., None]).sum(dim=(2, 3))
        mask = tri > 0
        sel = mask & (torch.cumsum(mask.to(torch.int32), 1) <= kp)
        written += int(torch.where(sel, tri, 0).sum(1).clamp(max=kk).sum())
        ops += (2 * int(adm.sum()) + 2 * m * int(meet.sum())
                + 2 * m_t * int(qmeet.sum()))
    return ops + min(written, s)


def dense_case(torch, kern, dk, table, qmat, m, s, k, prune, wide):
    """K1b.  Its operations are what this run's data needs
    (``dense_needed_ops``), counted only when the case is timed; the
    formula that counts every interval pair stands beside them."""
    b = qmat.shape[0]
    n, m_t = table.lo.shape
    cs = 8 if wide else 4
    nbytes = (n * (28 + 16 * m_t) + qmat.numel() * 8 + (2 + b) * 4
              + s * cs)

    def ops():
        return (dense_needed_ops(torch, dk, table, qmat, m, s, k, prune),
                {"ops_formula": b * n * (2 * m * m_t + 12)})
    return (lambda: kern.deps_dense(table, qmat, m, s, k, prune, wide),
            lambda: dk.flat_csr_plain(table, qmat, m, s, k, prune, wide),
            None, nbytes, ops)


def attr_case(torch, kern, dk, tlo, attr, aidx, rankb, hdr_raw, ent, m_t, m,
              floors, elide, tok=None):
    s = ent.shape[0]
    cs = ent.element_size()
    live = min(int(hdr_raw[0]), s)
    b = hdr_raw.shape[0] - 2
    aidx_bytes = sum(t.numel() * t.element_size() for t in aidx)
    nbytes = (2 * s * cs + (2 + b) * 4 + (5 + b) * 4 + live * (49 + 16)
              + aidx_bytes + b * 8)
    ops = live * 64
    return (lambda: kern.attr_post(tlo, attr, aidx, rankb, hdr_raw, ent, m_t,
                                   m, floors, elide, tok),
            lambda: dk.attr_post_plain(tlo, attr, aidx, rankb, hdr_raw, ent,
                                       m_t, m, floors, elide, tok),
            None, nbytes, ops)


def dense_edge_cases(torch, kern, dk, convert, dev) -> dict:
    """K1b at the edges of its tiling (256-slot tiles, 32-slot words,
    32-row groups, 256 phase-2 threads a row): N = 1, 31, 32, 33, 255, 257,
    4,097, 20,000, 50,000 and (on the card) 131,072; m_t = 1; m = 8
    against m_t = 8; B = 1, 33 and 600; a k that cuts kp inside a word,
    past the first thread's words, and an s that cuts inside a row; narrow
    and wide codes.  K2 on those raw CSRs
    with the raw total below, at and above s, and in the ``tok`` form."""
    cases = {}
    shapes = (("n1", dict(n=1), 4096, 64), ("n31", dict(n=31), 4096, 64),
              ("n32", dict(n=32), 4096, 64), ("n33", dict(n=33), 4096, 64),
              ("n255", dict(n=255, space=600), 4096, 64),
              ("n257", dict(n=257, space=600), 4096, 64),
              ("n4097", dict(n=4097, b=70, space=20_000), 1 << 16, 64),
              # more (tile, row group) items than the grid holds at once,
              # and more rows than CTAs
              ("n50k", dict(n=50_000, b=600, m=8, m_t=8, space=400_000),
               1 << 20, 512),
              ("mt1", dict(n=64, m_t=1), 4096, 64),
              ("m8mt8", dict(n=64, m=8, m_t=8), 4096, 64),
              ("b1", dict(n=64, b=1), 4096, 64),
              ("b33", dict(n=96, b=33), 4096, 64),
              ("kp_in_word", dict(n=64, b=8), 4096, 5),
              ("s_in_row", dict(n=64, b=8), 7, 64),
              # more than 256 x 32 slots: each phase-2 thread walks
              # several words, and the threads after the crossing one
              # start past kp, some on empty words
              ("kp_past_one_thread", dict(n=20_000, b=64, space=3000),
               1 << 16, 300))
    if dev.type == "cuda":
        # the main path's table size, its query and slot widths
        shapes += (("n131072", dict(n=131_072, b=64, m=8, m_t=8,
                                    space=2_000_000), 1 << 17, 512),)
    for i, (tag, shape, s, k) in enumerate(shapes):
        inp = small_inputs(40 + i, dk, **shape)
        up = convert.tables_from_numpy(
            {"table": inp["table"], "attr": inp["attr"],
             "aidx": inp["aidx"]}, dev)
        qd = torch.from_numpy(inp["qmat"]).to(dev)
        rankb = torch.from_numpy(inp["rankb"]).to(dev)
        m, m_t = inp["m"], inp["m_t"]
        for wide in (False, True):
            cases[f"deps_dense[{tag}{' i64' if wide else ''}]"] = dense_case(
                torch, kern, dk, up["table"], qd, m, s, k, inp["prune"],
                wide)
        hdr, ent = dk.flat_csr_plain(up["table"], qd, m, 4096, 64,
                                     inp["prune"])
        total = int(hdr[0])
        for tag2, s2 in (("lt", total + 37), ("eq", total),
                         ("gt", max(total * 2 // 3, 1))):
            hdr2, ent2 = dk.flat_csr_plain(up["table"], qd, m, s2, 64,
                                           inp["prune"])
            cases[f"attr_post[{tag} total {tag2} s]"] = attr_case(
                torch, kern, dk, up["table"].lo, up["attr"], up["aidx"],
                rankb, hdr2, ent2, m_t, m, True, True)
        # the tok form: each entry's token handed in (the mesh-bucketed
        # attribution), here the same lo[slot, col] the gather reads
        mq = m_t * m
        code = ent.to(torch.int64)
        tok = up["table"].lo[torch.clamp(code // mq, min=0),
                             torch.clamp(code % mq // m, 0, m_t - 1)]
        cases[f"attr_post[{tag} tok]"] = attr_case(
            torch, kern, dk, up["table"].lo, up["attr"], up["aidx"], rankb,
            hdr, ent, m_t, m, True, True, tok.contiguous())
    return cases


def scatter_case(torch, kern, dk, cols, idx, rows, live=False):
    """Kernel and plain version each write into their own copy.  The timed
    form hands the kernel device tensors; the live form (``live``) hands it
    numpy, as the mirrors do: one packed upload, then the kernel, against
    the plain version on the same packed layout and the library's upload
    of each column plus index_copy_."""
    dev = cols[0].device
    idx_t = torch.as_tensor(np.asarray(idx)).to(dev, torch.int64)
    rows_t = [torch.as_tensor(np.ascontiguousarray(r)).to(dev, c.dtype)
              for c, r in zip(cols, rows)]
    ck = [c.clone() for c in cols]
    cp = [c.clone() for c in cols]
    cl = [c.clone() for c in cols]
    p = len(idx_t)
    row_bytes = sum(dk.row_bytes(c) for c in cols)
    if live:
        idx_np = np.asarray(idx)
        rows_np = [np.asarray(r) for r in rows]
        offs, total = dk.pack_layout(cols, p)

        def run_kernel():
            kern.scatter_rows(ck, idx_np, rows_np)
            return tuple(ck)

        def run_plain():
            buf = np.empty(total, np.uint8)
            dk.pack_rows(buf, cols, idx_np, rows_np, offs)
            dk.scatter_rows_packed_plain(cp, torch.from_numpy(buf).to(dev),
                                         p, offs)
            return tuple(cp)

        def run_library():
            ii = torch.from_numpy(idx_np).to(dev, torch.int64)
            for c, r in zip(cl, rows_np):
                c.index_copy_(0, ii, torch.from_numpy(r).to(dev, c.dtype))
        return (run_kernel, run_plain, run_library,
                2 * p * row_bytes + p * 8, p * len(cols), LOGIC_OPS, total)
    else:
        def run_kernel():
            kern.scatter_rows(ck, idx_t, rows_t)
            return tuple(ck)

        def run_plain():
            dk.scatter_rows_plain(cp, idx_t, rows_t)
            return tuple(cp)

        def run_library():
            for c, r in zip(cl, rows_t):
                c.index_copy_(0, idx_t, r)

    return (run_kernel, run_plain, run_library, 2 * p * row_bytes + p * 8,
            p * len(cols))


def host_ms(fn, reps: int = 7) -> float:
    """Median ms of ``fn`` on the host clock, after one warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def pack_timings(torch, kern, dk, cols, idx, rows, on_cuda) -> dict:
    """K3's host packing at the largest recorded call and at row prefixes
    of it (a quarter each step, down to 64 KB): serial, and by the pool of
    ``kern.PACK_WORKERS`` threads (host medians); and the whole live call
    (pack, upload, kernel) at the largest call with each (CUDA events)."""
    idx = np.asarray(idx)
    rows = [np.asarray(r) for r in rows]
    p = len(idx)
    host = torch.empty(dk.pack_layout(cols, p)[1], dtype=torch.uint8,
                       pin_memory=on_cuda).numpy()
    out = {"workers": kern.PACK_WORKERS, "sizes": []}
    while True:
        offs, total = dk.pack_layout(cols, p)
        sub_idx, sub_rows = idx[:p], [r[:p] for r in rows]
        out["sizes"].append({
            "rows": p, "bytes": total,
            "serial_ms": host_ms(lambda: dk.pack_rows(
                host, cols, sub_idx, sub_rows, offs)),
            "pool_ms": host_ms(lambda: dk.pack_rows(
                host, cols, sub_idx, sub_rows, offs, kern._pack_pool(),
                kern.PACK_WORKERS))})
        if total < 1 << 16 or p < 8:
            break
        p //= 4
    ck = [c.clone() for c in cols]
    out["live_pool_ms"] = time_ms(
        torch, lambda: kern.scatter_rows(ck, idx, rows), on_cuda)
    keep = kern.PACK_PARALLEL_BYTES
    kern.PACK_PARALLEL_BYTES = 1 << 62
    try:
        out["live_serial_ms"] = time_ms(
            torch, lambda: kern.scatter_rows(ck, idx, rows), on_cuda)
    finally:
        kern.PACK_PARALLEL_BYTES = keep
    log("K3 packing, serial vs pool: " + json.dumps(out))
    return out


def scatter_cols(rng, kind, n, dev=None):
    """Seeded columns of one of the four scatters K3 replaces: the table
    (``table``: 32-byte interval rows; ``table_m3``: 24-byte ones), the
    attribution columns (bool among them), bucket rows of 3 entries
    (12-byte int32 rows) and the drain scalars; numpy, or tensors on
    ``dev``."""
    words = np.array([0, 1, (1 << 48) - 1, (1 << 62), -1, -(1 << 48)],
                     np.int64)

    def i64(*shape):
        return rng.choice(words, shape).astype(np.int64)

    def i32(*shape):
        return rng.integers(-1, 7, shape).astype(np.int32)
    if kind in ("table", "table_m3"):
        m_t = 4 if kind == "table" else 3
        cols = [i64(n), i64(n), i32(n), i32(n), i32(n), i64(n, m_t),
                i64(n, m_t)]
    elif kind == "attr":
        cols = [i32(n), i32(n), i64(n), i64(n), i32(n), i64(n), i64(n),
                i32(n), rng.random(n) < 0.5]
    elif kind == "bucket":
        cols = [i64(n, 3), i64(n, 3), i32(n, 3), i32(n, 3), i64(n, 3),
                i64(n, 3), i32(n, 3), i32(n, 3)]
    else:
        cols = [i32(n), i64(n), i64(n), i32(n)]
    if dev is None:
        return cols
    import torch
    return [torch.from_numpy(c).to(dev) for c in cols]


def scatter_edge_cases(torch, kern, dk, dev) -> dict:
    """K3 at P = 1, 7, 8 and 4,097 rows (pad rows repeating the last), on
    every scatter's columns (every dtype, bool included; rows of 12, 24
    and 32 bytes), in its timed and its live form."""
    cases = {}
    for kind in ("table", "table_m3", "attr", "bucket", "drain"):
        for p in (1, 7, 8, 4097):
            rng = np.random.default_rng(p * 10 + len(kind))
            n = 5000 if p > 8 else 64
            cols = scatter_cols(rng, kind, n, dev)
            distinct = {1: 1, 7: 7, 8: 5, 4097: 4000}[p]
            rows = np.sort(rng.choice(n, distinct, replace=False))
            idx = np.concatenate([rows, np.full(p - distinct, rows[-1])])
            src = [a[idx] for a in scatter_cols(rng, kind, n)]
            for live in (False, True):
                tag = f"[{kind} P{p}{' live' if live else ''}]"
                cases["scatter_rows" + tag] = scatter_case(
                    torch, kern, dk, cols, idx.astype(np.int32), src, live)
    return cases


def frontier_work(torch, drk, state):
    """(bytes, operations) one frontier sweep needs on this state: every
    row's status and its output flag; for each Stable row (no other row can
    be ready, whatever its adjacency), its own executeAt and awaits flag and
    its adjacency up to its first unapplied gating dependency (the whole
    row when it is ready); and the status and executeAt of every dependency
    those prefixes name.  Pad and free rows read their status only."""
    n = state.status.shape[0]
    dev = state.status.device
    if isinstance(state, drk.EllDrainState):
        blocking, j = drk._ell_blocking(state)
        named = state.adj_idx >= 0
        stops = blocking & (state.status[j] != drk.SLOT_APPLIED)
        width, entry = state.adj_idx.shape[1], 4
    else:
        blocking = drk.blocking_matrix(state)
        named = state.adj
        stops = blocking & (state.status != drk.SLOT_APPLIED)[None, :]
        j = torch.arange(n, device=dev)[None, :].expand(n, n)
        width, entry = n, 1
    stable = state.status == drk.SLOT_STABLE
    pos = torch.arange(width, device=dev)
    first = torch.where(stops, pos[None, :], width).min(dim=1).values
    prefix = torch.where(stable, torch.clamp(first + 1, max=width), 0)
    visited = pos[None, :] < prefix[:, None]
    read = visited & named
    exec_rows = stable.clone()
    exec_rows[j[read]] = True
    nbytes = (n * 4 + n + int(prefix.sum()) * entry
              + int(exec_rows.sum()) * 20 + int(stable.sum()))
    ops = int(visited.sum()) * 10 + n
    return nbytes, ops


def ell_out(kern) -> bool:
    """Do K4a and K6 ELL write into a given ``out`` (pinned host memory or
    the card's)?  An earlier tree's return a new device tensor (and its
    K6 ELL uploads a table of its members), which this script times
    too."""
    return "out" in inspect.signature(kern.frontier_ell).parameters


def _flags_buffer(torch, shape, out):
    """A kept output for a frontier's ``out`` form: pinned host memory
    ("pinned") or the card's ("device")."""
    if out == "pinned":
        return torch.empty(shape, dtype=torch.bool, pin_memory=True)
    return torch.empty(shape, dtype=torch.bool, device="cuda")


def ell_case(torch, kern, drk, state, tick=False, out=None):
    """K4a.  ``out``: into a kept "pinned" host buffer (one
    synchronisation a call) or a kept "device" tensor.  ``tick``: K4a as
    the solo ELL tick pays for it, since the drain mirror builds a new
    state for almost every tick: each call wraps the state's columns in a
    new EllDrainState, launches into a kept pinned host buffer (the
    mirror's ``ready_buffer``) and reads the flags after one
    synchronisation of the stream (a tree without ``out``: launches and
    downloads by ``.cpu()``, the earlier tick)."""
    kfn = lambda: kern.frontier_ell(state)
    pfn = lambda: drk.ready_frontier_ell_plain(state)
    n = state.status.shape[0]
    if out:
        kept = _flags_buffer(torch, (n,), out)

        def kfn():
            kern.frontier_ell(state, out=kept)
            if out == "pinned":
                torch.cuda.current_stream().synchronize()
            return kept
        if out == "pinned":
            pfn = lambda: drk.ready_frontier_ell_plain(state).cpu()
    if tick:
        cols = tuple(state)
        kept = torch.empty(n, dtype=torch.bool, pin_memory=True)

        def kfn():
            fresh = drk.EllDrainState(*cols)
            if not ell_out(kern):
                return kern.frontier_ell(fresh).cpu()
            kern.frontier_ell(fresh, out=kept)
            torch.cuda.current_stream().synchronize()
            return kept

        pfn = lambda: drk.ready_frontier_ell_plain(state).cpu()
    return (kfn, pfn, None, *frontier_work(torch, drk, state))


def dense_frontier_case(torch, kern, drk, state, tick=None):
    """K4b; the library call is torch.any of the precomputed blocking
    against the unapplied columns (as K13's).  ``tick``: K4b as the solo
    dense tick pays for it, since the drain mirror builds a new state for
    almost every tick: each call wraps the state's columns in a new
    DrainState ("planned": planned by ``kernels.checked_cols``), launches
    into the first N bytes of a kept pinned host buffer (the mirror's
    ``ready_buffer``) and reads the flags after one synchronisation of
    the stream."""
    blk = drk.blocking_matrix(state)
    unapplied = state.status != 5
    kfn = lambda: kern.frontier_dense(state)
    pfn = lambda: drk.ready_frontier_plain(state)
    if tick:
        cols, n = tuple(state), state.status.shape[0]
        kept = torch.empty(n, dtype=torch.bool, pin_memory=True)
        wrap = kern.checked_cols if tick == "planned" else (lambda st: st)

        def kfn():
            buf = kept[:n]
            kern.frontier_dense(wrap(drk.DrainState(*cols)), out=buf)
            torch.cuda.current_stream().synchronize()
            return buf

        pfn = lambda: drk.ready_frontier_plain(state).cpu()
    return (kfn, pfn, lambda: torch.any(blk & unapplied[None, :], dim=1),
            *frontier_work(torch, drk, state))


def fused_scan_case(torch, kern, dk, tables, qmats, prunes, m, s, k,
                    wide=False):
    """K5 raw stage: each member's dense-scan work over its own table.
    Its operations are what each member's data needs
    (``dense_needed_ops`` over the member's own table, row block and
    prune floor), counted only when the case is timed; the formula that
    counts every interval pair, sum b n_i (2 m m_t_i + 12), stands
    beside them."""
    n_s, b = qmats.shape[:2]
    cs = 8 if wide else 4
    nbytes = (sum(t.lo.shape[0] * (28 + 16 * t.lo.shape[1]) for t in tables)
              + qmats.numel() * 8 + n_s * ((2 + b) * 4 + s * cs))

    def ops():
        need = sum(dense_needed_ops(
            torch, dk, t, qmats[i], m, s, k,
            tuple(int(p[i]) for p in prunes)) for i, t in enumerate(tables))
        return need, {"ops_formula": sum(
            b * t.lo.shape[0] * (2 * m * t.lo.shape[1] + 12)
            for t in tables)}
    return (lambda: kern.fused_deps_dense(tables, qmats, prunes, m, s, k,
                                          wide),
            lambda: dk.fused_flat_csr_plain(tables, qmats, prunes, m, s, k,
                                            wide),
            None, nbytes, ops)


def fused_attr_case(torch, kern, dk, tables, attrs, aidxs, rankbs, hdr_raw,
                    ent, m, floors=True, elide=True):
    """K5 attribution stage: each member's live entries read once, the
    attributed blocks written once."""
    n_s, s = ent.shape
    b = hdr_raw.shape[1] - 2
    cs = ent.element_size()
    live = int(torch.clamp(hdr_raw[:, 0].to(torch.int64), max=s).sum())
    aidx_bytes = sum(t.numel() * t.element_size() for a in aidxs for t in a)
    nbytes = (2 * n_s * s * cs + n_s * ((2 + b) * 4 + (5 + b) * 4 + b * 8)
              + live * (49 + 16) + aidx_bytes)
    return (lambda: kern.fused_attr_post(tables, attrs, aidxs, rankbs,
                                         hdr_raw, ent, m, floors, elide),
            lambda: dk.fused_attr_post_plain(tables, attrs, aidxs, rankbs,
                                             hdr_raw, ent, m, floors, elide),
            None, nbytes, live * 64)


FULL_SPAN = (int(np.iinfo(np.int64).min), int(np.iinfo(np.int64).max))


def fused_group(torch, convert, dev, dk, seed, shapes, b, empty=(),
                full=False):
    """A seeded fused group: members of (capacity, interval width) with
    their attribution inputs, stacked qmats and rank bounds, and the
    prune triples; the members in ``empty`` have every slot FREE (their
    rows select nothing), and with ``full`` one query interval of member
    0 is the whole line, so that it overlaps the PAD columns the group's
    wider members add."""
    ins = [small_inputs(seed * 1000 + i, dk, n=n, m_t=m_t, b=b)
           for i, (n, m_t) in enumerate(shapes)]
    for i in empty:
        ins[i]["table"][4][:] = -1
    qmats = np.stack([x["qmat"] for x in ins])
    m = ins[0]["m"]
    if full:
        r = min(2, b - 1)
        qmats[0, r, 7], qmats[0, r, 7 + m] = FULL_SPAN
    ups = [convert.tables_from_numpy(
        {"table": x["table"], "attr": x["attr"], "aidx": x["aidx"]}, dev)
        for x in ins]
    return {"tables": [u["table"] for u in ups],
            "attrs": [u["attr"] for u in ups],
            "aidxs": [u["aidx"] for u in ups],
            "qmats": torch.from_numpy(qmats).to(dev),
            "rankbs": torch.from_numpy(np.stack([x["rankb"] for x in ins]))
            .to(dev),
            "prunes": tuple(np.array([x["prune"][c] for x in ins], np.int64)
                            for c in range(3)), "m": m}


def fused_edge_cases(torch, kern, dk, convert, dev) -> dict:
    """K5 at the edges of its work split (the CPU tests' groups): members
    of 300 slots (not a whole number of 256-slot tiles), 40 (less than a
    tile) and 96 with every slot FREE, unequal interval widths and a query
    interval over the whole line (the PAD columns' pairs); B = 33 (two row
    groups) and B = 1; a k that cuts kp inside a word with int64 codes;
    s and k both overflowing; two stores; and one store more than a launch
    takes by value (``FUSED_MAX_STORES``), so the group over the cap.
    The attribution runs on the plain raw CSR with the group's leg
    switches."""
    cap = kern.FUSED_MAX_STORES
    edge = ((300, 4), (40, 2), (96, 8))
    groups = (("tiles b33", edge, 33, 8192, 256, False, True, True),
              ("kp_in_word b1 i64", edge, 1, 8192, 5, True, False, True),
              ("overflow", edge, 8, 24, 3, False, True, False),
              ("two stores", ((64, 4), (64, 4)), 4, 4096, 64, False, False,
               False),
              (f"{cap + 1} stores", ((16, 2),) * (cap + 1), 2, 256, 16, False,
               True, True))
    cases = {}
    for i, (tag, shapes, b, s, k, wide, floors, elide) in enumerate(groups):
        g = fused_group(torch, convert, dev, dk, 70 + i, shapes, b,
                        empty=(2,) if len(shapes) == 3 else (),
                        full=len(shapes) == 3)
        cases[f"fused_deps_dense[{tag}]"] = fused_scan_case(
            torch, kern, dk, g["tables"], g["qmats"], g["prunes"], g["m"], s,
            k, wide)
        hdr, ent = dk.fused_flat_csr_plain(g["tables"], g["qmats"],
                                           g["prunes"], g["m"], s, k, wide)
        cases[f"fused_attr_post[{tag} {floors:d}{elide:d}]"] = \
            fused_attr_case(torch, kern, dk, g["tables"], g["attrs"],
                            g["aidxs"], g["rankbs"], hdr, ent, g["m"],
                            floors, elide)
    return cases


def fused_flush_timing(torch, fn, on_cuda: bool, reps: int = 15,
                       warm: int = 3, busy: int = 0) -> dict:
    """One whole fused flush call: the host's wall time to enqueue it (the
    call's return), its wall time to the end of its device work, and its
    CUDA-event time, medians over ``reps`` calls after ``warm``; an
    enqueue time near the whole call's means the host waited on the card
    inside the call.  ``busy``: each call comes behind that many clock
    cycles of queued device work (``torch.cuda._sleep``), as a flush
    comes behind its stores' scatters; its CUDA-event time starts after
    that work."""
    for _ in range(warm):
        fn()
    if on_cuda:
        torch.cuda.synchronize()
    enq, wall, ev = [], [], []
    for _ in range(reps):
        if on_cuda:
            if busy:
                torch.cuda._sleep(busy)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        if on_cuda:
            b.record()
            b.synchronize()
        t2 = time.perf_counter()
        enq.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
        if on_cuda:
            ev.append(a.elapsed_time(b))
    return {"enqueue_ms": statistics.median(enq),
            "wall_ms": statistics.median(wall),
            "ms": statistics.median(ev) if ev else None}


def pinned_upload(torch, arrays, dev) -> tuple:
    """Copies of host arrays on ``dev`` by one asynchronous copy: packed at
    16-byte offsets into one buffer of PyTorch's pinned-memory cache (which
    reuses it only once the copy has completed, so the host never waits),
    uploaded, and viewed.  The yardstick a fused flush's two pageable
    uploads are timed against."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 16) * 16
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    hb = host.numpy()
    for a, o in zip(arrays, offs):
        hb[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    staged = host.to(dev, non_blocking=True)
    return tuple(staged[o:o + a.nbytes].view(torch.from_numpy(a).dtype)
                 .view(a.shape) for a, o in zip(arrays, offs))


def k6_by_value(kern) -> bool:
    """Does K6 dense take its members by value and write into a given
    ``out`` (a pinned host buffer)?  An earlier tree's uploads a table of
    them and returns a device tensor, which this script times too."""
    return "out" in inspect.signature(kern.fused_frontier_dense).parameters


def fused_frontier_case(torch, kern, drk, states, tick=False, out=None):
    """K6: the members' own frontier work (pad rows need nothing).
    ``tick``: K6 as the fused drain tick pays for it, since the mirrors
    build new states for almost every tick: each call wraps the members'
    columns in new drain states, launches into a kept pinned host buffer
    and reads the flags after one synchronisation of the stream (a tree
    without ``out``: launches and downloads by ``.cpu()``).  ``out``:
    into a kept "pinned" host buffer (one synchronisation a call) or a
    kept "device" tensor."""
    work = [frontier_work(torch, drk, st) for st in states]
    ell = isinstance(states[0], drk.EllDrainState)
    fn = kern.fused_frontier_ell if ell else kern.fused_frontier_dense
    has_out = ell_out(kern) if ell else k6_by_value(kern)
    kfn = lambda: fn(states)
    pfn = (drk.fused_ready_frontier_ell_plain if ell
           else drk.fused_ready_frontier_plain)
    pfn_ = lambda: pfn(states)
    n_max = max(st.status.shape[0] for st in states)
    if out:
        kept_o = _flags_buffer(torch, (len(states), n_max), out)

        def kfn():
            fn(states, out=kept_o)
            if out == "pinned":
                torch.cuda.current_stream().synchronize()
            return kept_o
        if out == "pinned":
            pfn_ = lambda: pfn(states).cpu()
    if tick:
        cols = [tuple(st) for st in states]
        cls = drk.EllDrainState if ell else drk.DrainState
        kept = torch.empty(len(states) * n_max, dtype=torch.bool,
                           pin_memory=True).view(len(states), n_max)

        def kfn():
            fresh = [cls(*c) for c in cols]
            if not has_out:
                return fn(fresh).cpu()
            fn(fresh, out=kept)
            torch.cuda.current_stream().synchronize()
            return kept

        pfn_ = lambda: pfn(states).cpu()
    lfn = None
    if not ell and len({st.adj.shape for st in states}) == 1:
        # members of one shape: torch.any over the stacked masked blocking
        blk = torch.stack([drk.blocking_matrix(st) for st in states])
        unapplied = torch.stack([st.status != 5 for st in states])

        def lfn():
            return torch.any(blk & unapplied[:, None, :], dim=2)
    return (kfn, pfn_, lfn, sum(w[0] for w in work),
            sum(w[1] for w in work))


def level_work(torch, drk, state, out_bytes=None):
    """(bytes, operations) of one level pass: every row's status and its
    output (``out_bytes``, the levels by default); the adjacency, executeAt
    and awaits of the Stable rows (only their blocking deps carry levels);
    one relax over those edges (a topological pass needs no more).  A drain
    to fixpoint computes the same function (its sweeps are the levels)."""
    n = state.status.shape[0]
    stable = int((state.status == drk.SLOT_STABLE).sum())
    width = (state.adj_idx.shape[1] if isinstance(state, drk.EllDrainState)
             else n)
    entry = 4 if isinstance(state, drk.EllDrainState) else 1
    out = n * 4 + 4 if out_bytes is None else out_bytes
    return (n * 4 + out + stable * (width * entry + 21),
            stable * width * 10 + n)


def level_case(torch, kern, drk, state):
    """K7."""
    ell = isinstance(state, drk.EllDrainState)
    return ((lambda: kern.level_ell(state)) if ell
            else (lambda: kern.level_dense(state)),
            (lambda: drk.level_assign_ell_plain(state)) if ell
            else (lambda: drk.level_assign_dense_plain(state)),
            None, *level_work(torch, drk, state))


def dense_state(n, edges, status, msb=None, awaits=()):
    """A dense drain input of ``n`` rows: ``edges`` (row, dep) pairs,
    executeAt ascending by slot unless ``msb`` is given, node 1."""
    adj = np.zeros((n, n), bool)
    if len(edges):
        e = np.asarray(edges)
        adj[e[:, 0], e[:, 1]] = True
    aw = np.zeros(n, bool)
    aw[list(awaits)] = True
    return (adj, np.asarray(status, np.int32),
            np.arange(n, dtype=np.int64) if msb is None else msb,
            np.zeros(n, np.int64), np.ones(n, np.int32), aw)


def random_dag(n, deg, seed):
    """``n`` Stable rows (row 0 applied), each waiting on ``deg`` random
    earlier rows, executeAt ascending: every edge gates."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(1, n), deg)
    deps = (rng.random(len(rows)) * rows).astype(np.int64)
    st = np.full(n, 4)
    st[0] = 5
    return dense_state(n, np.stack([rows, deps], 1), st)


def level_graphs(card: bool) -> dict:
    """K7 dense's edge inputs (the CPU tests' edge cases, at the card's
    sizes): Stable rows with more than 32 blocking deps (each row of an
    antichain of 64 waits on every row of the one before, so 4,032 rows x
    64 deps do not fit the lists' regions, or 33 deps a row at 512 rows,
    which fit the first CTA), a 300-row chain closed by an ``awaits_all``
    cycle at its tail (N not a multiple of 16), 256 rows all Stable and
    blocked behind a cycle at the head, and a random DAG at the first
    CTA's shared-memory cap (1,024 rows, 30 deps a row).  Off the card
    (a rehearsal) the 4,096-row input is left out."""
    def fanin(n, fan):
        rows = np.arange(fan, n)
        edges = [(i, j) for i in rows
                 for j in range(i // fan * fan - fan, i // fan * fan)]
        return dense_state(n, edges, [5] * fan + [4] * (n - fan),
                           msb=np.arange(n, dtype=np.int64) // fan)
    n = 300
    chain = [(i, i - 1) for i in range(1, n)] + [(n - 2, n - 1)]
    blocked = [(i, i - 1) for i in range(1, 256)] + [(0, 1)]
    out = {"fanin64 n4096": fanin(4096, 64)} if card else {}
    return {**out, "fanin33 n512": fanin(512, 33),
            "chain300 cycle": dense_state(n, chain, [5] + [4] * (n - 1),
                                          awaits=(n - 2,)),
            "all blocked n256": dense_state(256, blocked, [4] * 256,
                                            awaits=(0,)),
            "dag1024x30": random_dag(1024, 30, 7)}


def chain_ell(n, d=1):
    """A serial chain of ``n`` rows in ELL form, ``d`` wide (head
    applied: n - 1 Stable rows)."""
    idx = np.full((n, d), -1, np.int32)
    idx[1:, 0] = np.arange(n - 1)
    st = np.full(n, 4, np.int32)
    st[0] = 5
    return (idx, st, np.arange(n, dtype=np.int64), np.zeros(n, np.int64),
            np.ones(n, np.int32), np.zeros(n, bool))


def blocked_chain_ell(n):
    """A chain of ``n`` Stable rows whose head waits on a Committed row
    (slot n): every level INF, through K7 ELL's constant INF row."""
    idx, st, msb, lsb, node, aw = chain_ell(n + 1)
    idx[0, 0] = n
    idx[n, 0] = -1
    st = np.full(n + 1, 4, np.int32)
    st[n] = 3
    msb = (msb + 1) % (n + 1)   # the Committed row executes first: it gates
    return idx, st, msb, lsb, node, aw


def stable_dag_ell(n, d=8, seed=43):
    """``n`` Stable rows in ELL form, executeAt ascending: the first ``d``
    wait on nothing, every later row on ``d`` random earlier rows
    (repeats kept), so every edge gates and K7 ELL lists ``d * (n - d)``
    entries."""
    rng = np.random.default_rng(seed)
    idx = np.full((n, d), -1, np.int32)
    rows = np.arange(d, n)
    idx[d:] = (rng.random((len(rows), d)) * rows[:, None]).astype(np.int32)
    return (idx, np.full(n, 4, np.int32), np.arange(n, dtype=np.int64),
            np.zeros(n, np.int64), np.ones(n, np.int32), np.zeros(n, bool))


# K7 ELL's first CTA takes the rounds of A Stable rows with E list entries
# when A <= 4,096 and 6 (A + 2) + E <= 56,320 (LEVEL_SMEM / 4): inputs
# either side of each cap, and the form each must take
LEVEL_ELL_CAPS = {"rows under": (lambda: chain_ell(4097), "first CTA"),
                  "rows over": (lambda: chain_ell(4098), "grid"),
                  "smem under": (lambda: stable_dag_ell(4026), "first CTA"),
                  "smem over": (lambda: stable_dag_ell(4027), "grid")}


def level_ell_graphs(card: bool) -> dict:
    """K7 ELL's edge inputs: either side of its first CTA's caps (at the
    row cap with the constant rows Z and I each referenced), D = 1
    (a chain) and D = 33 (each row of an antichain of 33 waits on every
    row of the one before), an ``awaits_all`` cycle at a 300-row chain's
    tail, 256 rows all Stable and blocked, and (the card only) 131,072
    Stable rows of 8 deps (the grid form) and 270,000 of 2 (more rows
    than the grid has threads, more than a CTA's threads a CTA)."""
    dense = level_graphs(False)
    out = {f"cap {k}": f() for k, (f, _form) in LEVEL_ELL_CAPS.items()}
    out.update({"cap rows under, blocked": blocked_chain_ell(4096),
                "chain d1 n1000": chain_ell(1000),
                "fanin33 d33 n512": ell_of(dense["fanin33 n512"]),
                "chain300 cycle": ell_of(dense["chain300 cycle"]),
                "all blocked n256": ell_of(dense["all blocked n256"])})
    if card:
        out["all stable 131072"] = stable_dag_ell(131072)
        out["stable 270000 d2"] = stable_dag_ell(270_000, 2)
    return out


def level_ell_form(kern, state):
    """(the K7 ELL stats of one call on ``state``, its form), or None on a
    tree whose K7 ELL reports none."""
    if not hasattr(kern, "level_ell_stats"):
        return None
    lv, rounds = kern.level_ell(state)
    return dict(kern.level_ell_stats(lv), rounds=int(rounds),
                n=int(state.status.shape[0]), d=int(state.adj_idx.shape[1]))


class LevelStats:
    """Wrap K7 ELL's wrapper to note what each call of the main path found:
    its rows, Stable rows A, list entries E and the form its rounds took
    (one synchronisation a call, outside the launch)."""

    def __init__(self, kern, on_cuda: bool):
        self.kern, self.orig, self.calls = kern, kern.level_ell, []
        self.orig_drain = getattr(kern, "level_drain_ell", None)
        noted = on_cuda and hasattr(kern, "level_ell_stats")

        def note(state, out, rounds):
            if noted:
                self.calls.append(dict(
                    kern.level_ell_stats(out), rounds=int(rounds),
                    n=int(state.status.shape[0])))

        def wrapped(state):
            lv, rounds = self.orig(state)
            note(state, lv, rounds)
            return lv, rounds

        def wrapped_drain(state, watermark=None):
            out = self.orig_drain(state, watermark)
            note(state, out[0], out[2])
            return out
        kern.level_ell = wrapped
        if self.orig_drain is not None:
            kern.level_drain_ell = wrapped_drain

    def restore(self):
        self.kern.level_ell = self.orig
        if self.orig_drain is not None:
            self.kern.level_drain_ell = self.orig_drain


def fix_case(torch, kern, drk, state):
    """K8: the fixpoint drain (applied, newly, sweeps)."""
    n = state.status.shape[0]
    if isinstance(state, drk.EllDrainState):
        kfn, pfn = kern.drain_fix_ell, drk._drain_ell_fix_plain
    else:
        kfn, pfn = kern.drain_fix_dense, drk._drain_fix_plain
    return (lambda: kfn(state), lambda: pfn(state), None,
            *level_work(torch, drk, state, 2 * n + 4))


def wide_drain_input(convert, dev, n, levels=4, deg=8, seed=31):
    """A wide K8 input: ``n`` Stable rows in ``levels`` antichains of n /
    levels rows, scattered over the slots; a row of antichain l > 0 waits
    on ``deg`` random rows of antichain l - 1 (executeAt ascending by
    antichain), so the fixpoint takes levels + 1 sweeps."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    level = np.empty(n, np.int64)
    level[perm] = np.arange(n) * levels // n
    adj = np.zeros((n, n), bool)
    for lv in range(1, levels):
        rows = np.nonzero(level == lv)[0]
        prev = np.nonzero(level == lv - 1)[0]
        adj[np.repeat(rows, deg), rng.choice(prev, deg * len(rows))] = True
    return convert.tables_from_numpy({"drain": (
        adj, np.full(n, 4, np.int32), level * n + np.arange(n),
        np.zeros(n, np.int64), np.ones(n, np.int32), np.zeros(n, bool))},
        dev)["drain"]


def sync_probe_us(torch, mode: int, blocks: int, threads: int,
                  iters: int = 4096) -> dict:
    """One step of ``ops/csrc/probes.cu``'s empty loops (mode 0: a grid
    barrier of a cooperative grid of ``blocks`` x ``threads``; mode 1: a
    block barrier and a shared-memory round trip; mode 2: two dependent
    reads from L2, along a random cycle over 4 MB, and a block barrier),
    in us: the CUDA-event time of ``iters`` + 1 steps less that of one,
    over ``iters``."""
    import ctypes
    from accord_tpu_torch.ops import _build
    fn = _build.library().accord_sync_probe
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    chain = torch.zeros(1, dtype=torch.int32, device="cuda")
    if mode == 2:
        perm = np.random.default_rng(5).permutation(1 << 20)
        nxt = np.empty(1 << 20, np.int32)
        nxt[perm] = np.roll(perm, -1)
        chain = torch.from_numpy(nxt).to("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(it):
        p = (ctypes.c_uint64 * 2)(out.data_ptr(), chain.data_ptr())
        v = (ctypes.c_int64 * 4)(mode, blocks, threads, it)
        rc = fn(p, v, stream)
        check(rc == 0, f"sync probe mode {mode}: error {rc}")

    t = {it: time_ms(torch, lambda it=it: run(it), True, reps=7, warm=2)
         for it in (1, iters + 1)}
    return {"us": (t[iters + 1] - t[1]) / iters * 1e3,
            "blocks": int(out[0]) if mode == 0 else 1, "threads": threads}


def launch_floor(kern, dev) -> None:
    """One empty kernel (``ops/csrc/probes.cu``) through the launch path
    that K4b takes (``kernels._launch_packed``), its arguments packed
    once: the least time a short call can take.  It counts no launch."""
    from accord_tpu_torch.ops import _build
    p = FLOOR_ARGS.buffer_info()[0]
    kern._launch_packed("empty_probe", dev.index or 0,
                        _build.entries()["empty_probe"], p, p)


def bucket_row_stats(torch, dk, a, kw) -> dict:
    """Per query row of one K1a call: its candidates C, the valid ones nv
    and the unique ones (percentiles over the rows)."""
    m_t, buckets, qmat, m, span, s, k = a[:7]
    prune = a[7] if len(a) > 7 else kw.get("prune")
    keff = a[8] if len(a) > 8 else kw.get("keff")
    wide = a[9] if len(a) > 9 else kw.get("wide", False)
    row_offset = kw.get("row_offset")
    pred, cand = dk.bucket_candidates(m_t, buckets, qmat, m, span, prune,
                                      keff, wide, row_offset)
    hdr, _ent = dk.bucketed_flat_plain(m_t, buckets, qmat, m, span, s, k,
                                       prune, keff, wide, row_offset)
    ends = hdr[2:].to(torch.int64)
    uniq = torch.diff(ends, prepend=ends.new_zeros(1))
    nv = pred.sum(dim=1)

    def pct(x):
        x = torch.sort(x.to(torch.int64).cpu()).values
        return [int(x[min(len(x) - 1, int(q * len(x)))]) for q in
                (0.0, 0.5, 0.9, 0.99)] + [int(x[-1])]
    return {"B": int(qmat.shape[0]), "C": int(pred.shape[1]),
            "W": int(buckets.wlo.shape[0]), "s": int(s), "k": int(k),
            "nv_p0_50_90_99_max": pct(nv),
            "unique_p0_50_90_99_max": pct(uniq),
            "rows_nv_le_32": int((nv <= 32).sum())}


def levels_graph(sizes, n_pad, seed, deg=3):
    """Stable rows in antichains of ``sizes`` rows, scattered over
    ``n_pad`` slots (the rest FREE): a row of antichain l > 0 waits on 1 to
    ``deg`` rows of antichain l - 1, executeAt ascending by antichain (the
    CPU tests' ``_levels_graph``)."""
    rng = np.random.default_rng(seed)
    slots = rng.permutation(n_pad)[:sum(sizes)]
    adj = np.zeros((n_pad, n_pad), bool)
    status = np.full(n_pad, -1, np.int32)
    msb = np.zeros(n_pad, np.int64)
    ends = np.cumsum(sizes)
    for lv, (a, b) in enumerate(zip(ends - sizes, ends)):
        status[slots[a:b]] = 4
        msb[slots[a:b]] = lv
        if lv:
            prev = slots[a - sizes[lv - 1]:a]
            for i in slots[a:b]:
                adj[i, rng.choice(prev, int(rng.integers(1, deg + 1)))] = True
    return (adj, status, msb, np.zeros(n_pad, np.int64),
            np.ones(n_pad, np.int32), np.zeros(n_pad, bool))


def k8_graphs(dev) -> dict:
    """K8 dense's edge graphs: N = 0, 1, 31, 33 and 4,097 (rows not
    16-byte aligned), a level either side of the handover size and a wide
    level after the handover (back to the grid), and (on the card) 8,193
    rows, past the lists held in shared memory."""
    from accord_tpu_torch.ops import _build
    h = _build.GEOMETRY["ACCORD_DRAIN_HANDOVER"]
    graphs = {"n0": levels_graph((), 0, 1), "n1": levels_graph((1,), 1, 2),
              "n31": small_drain(70, 31)[0], "n33": small_drain(71, 33)[0],
              "handover_below": levels_graph((h - 1, 3, 3), 4 * h, 11),
              "handover_at": levels_graph((h, 3, 3), 4 * h, 12),
              "handover_above": levels_graph((h + 1, 3, 3), 4 * h, 13),
              "handover_later": levels_graph((h + 1, h, h + 1, 2), 4 * h, 14),
              "wide_after_handover": levels_graph((2, 1500, 1500, 3), 3100,
                                                  15),
              "n4097": levels_graph((1800, 1500, 797), 4097, 7)}
    if dev.type == "cuda":
        graphs["n8193"] = levels_graph((4000, 8, 4000, 185), 8193, 16)
    return graphs


def fix_edge_cases(torch, kern, drk, convert, dev) -> dict:
    """K8 dense on its edge graphs (``k8_graphs``)."""
    return {f"drain_fix_dense[{tag}]": fix_case(
        torch, kern, drk,
        convert.tables_from_numpy({"drain": g}, dev)["drain"])
        for tag, g in k8_graphs(dev).items()}


def ell_of(dense):
    """The ELL form of a dense case: a row's deps in slot order, -1 padded
    to the widest row (at least one column)."""
    adj = dense[0]
    width = max(1, int(adj.sum(axis=1).max(initial=0)))
    idx = np.full((adj.shape[0], width), -1, np.int32)
    for i in range(adj.shape[0]):
        e = np.nonzero(adj[i])[0]
        idx[i, :len(e)] = e
    return (idx,) + tuple(dense[1:])


def levels_ell(sizes, n_pad, seed, deg=3):
    """``levels_graph`` in ELL form, built without the dense array: a row
    of antichain l > 0 lists 1 to ``deg`` rows of antichain l - 1, drawn
    with replacement (a dep may repeat), -1 padded to ``deg``."""
    rng = np.random.default_rng(seed)
    slots = rng.permutation(n_pad)[:sum(sizes)]
    idx = np.full((n_pad, deg), -1, np.int32)
    status = np.full(n_pad, -1, np.int32)
    msb = np.zeros(n_pad, np.int64)
    ends = np.cumsum(sizes)
    for lv, (a, b) in enumerate(zip(ends - sizes, ends)):
        rows = slots[a:b]
        status[rows] = 4
        msb[rows] = lv
        if lv:
            prev = slots[a - sizes[lv - 1]:a]
            k = rng.integers(1, deg + 1, len(rows))
            pick = rng.choice(prev, (len(rows), deg))
            idx[rows] = np.where(np.arange(deg)[None, :] < k[:, None], pick,
                                 -1)
    return (idx, status, msb, np.zeros(n_pad, np.int64),
            np.ones(n_pad, np.int32), np.zeros(n_pad, bool))


def ell_graph(n, rows, status, msb=None, node=None, awaits=()):
    """A hand-made ELL case: ``rows`` {i: its adj_idx row, -1 holes and
    duplicates kept}, -1 padded to the widest; executeAt ascending by slot
    unless ``msb`` / ``node`` say otherwise (the CPU tests' ``_ell_graph``)."""
    width = max(len(r) for r in rows.values())
    idx = np.full((n, width), -1, np.int32)
    for i, r in rows.items():
        idx[i, :len(r)] = r
    return (idx, np.asarray(status, np.int32),
            np.asarray(range(n) if msb is None else msb, np.int64),
            np.zeros(n, np.int64),
            np.asarray([1] * n if node is None else node, np.int32),
            np.asarray([i in awaits for i in range(n)], bool))


def hot_legs_ell(n, chains, d=8, seed=41):
    """``hot_drain_legs``'s ELL drain at ``n`` rows in ``chains`` hot
    chains (every row Stable, executeAt ascending by slot)."""
    rng = np.random.default_rng(seed)
    idx = np.full((n, d), -1, np.int32)
    for i in range(chains, n):
        idx[i, 0] = i - chains
        extra = rng.integers(1, d, 1)[0]
        lo = max(0, i - 3 * chains)
        if lo < i - 1:
            idx[i, 1:1 + extra] = rng.integers(lo, i - 1, extra)
    return (idx, np.full(n, 4, np.int32), np.arange(n, dtype=np.int64),
            np.zeros(n, np.int64), np.ones(n, np.int32), np.zeros(n, bool))


def fix_ell_edge_cases(torch, kern, drk, convert, dev) -> dict:
    """K8 ELL at the edges of its frontier form (the CPU tests' cases): the
    ELL forms of K8 dense's edge graphs, a first level either side of the
    ELL handover and a wide level after it, duplicate deps (counted per
    edge), -1 holes, FREE and INVALIDATED deps, executeAt ties, a count
    past a byte (D = 300), config 3's hot chains at 4,096 rows, two rows
    that 6,400 wait on (a level of 2 rows and 1,068 items); on the
    card 100,000 rows whose wide levels the first CTA hands back to the
    grid (its counts in shared memory written back), and 120,000 rows
    whose counts do not fit it."""
    from accord_tpu_torch.ops import _build
    h = _build.GEOMETRY["ACCORD_DRAIN_HANDOVER_ELL"]
    graphs = {f"dense {k}": ell_of(g) for k, g in k8_graphs(dev).items()}
    graphs.update({
        "handover_below": levels_ell((h - 1, 3, 3), 4 * h, 21),
        "handover_at": levels_ell((h, 3, 3), 4 * h, 22),
        "handover_above": levels_ell((h + 1, 3, 3), 4 * h, 23),
        "handover_later": levels_ell((h + 1, h, h + 1, 2), 4 * h, 24),
        "duplicates": ell_graph(
            6, {2: [1], 3: [1, 2, 1], 4: [0, 3, 0, 3], 5: [5, 4, 5]},
            [5, 4, 4, 4, 4, 4], awaits=(5,)),
        "holes": ell_graph(
            6, {1: [-1, 0, -1], 2: [-1, -1, 1], 3: [1, -1, 2, -1],
                5: [-1, 3]}, [4] * 6),
        "free_invalidated": ell_graph(
            6, {0: [1, 2], 4: [2, 0, 1], 5: [1, 3]}, [4, -1, 6, 1, 4, 4]),
        "ties": ell_graph(5, {1: [0], 2: [0, 1], 3: [2], 4: [3, 1]}, [4] * 5,
                          msb=[3] * 5, node=[1, 2, 3, 1, 4]),
        "wide_rows": ell_graph(
            4, {1: [0] * 260 + [-1] * 40, 2: [1] * 300, 3: [2, 0]}, [4] * 4),
        "hot_legs": hot_legs_ell(4096, 32),
        "hubs": ell_graph(6402, {i: [0, 1] for i in range(2, 6402)},
                          [4] * 6402)})
    if dev.type == "cuda":
        graphs["n100k wide levels handed back"] = levels_ell(
            (2, 1, 3000, 3000, 2, 1), 100_000, 25)
        graphs["n120k counts past shared memory"] = levels_ell(
            (600, 30_000, 2, 30_000, 1), 120_000, 26)
    return {f"drain_fix_ell[{tag}]": fix_case(
        torch, kern, drk, convert.tables_from_numpy({"ell": g}, dev)["ell"])
        for tag, g in graphs.items()}


def fused_k9(kern) -> bool:
    """Whether K9's level-drain epilogue runs inside K7's launch (else, on
    an earlier tree, it is a launch of its own after K7's)."""
    return hasattr(kern, "level_drain_ell")


def level_drain_case(torch, kern, drk, state, watermark=None):
    """A log-depth drain, (applied, newly, rounds, depth): K7 with K9's
    level-drain epilogue, one launch (on an earlier tree the K7 call and
    the K9 call), against level_drain_plain over the plain levels.  Work:
    the level pass's, the two flags, the rounds and the depth written."""
    n = state.status.shape[0]
    ell = isinstance(state, drk.EllDrainState)
    if fused_k9(kern):
        fused = kern.level_drain_ell if ell else kern.level_drain_dense

        def run():
            return fused(state, watermark)
    else:
        def run():
            lv, rounds = (kern.level_ell if ell else kern.level_dense)(state)
            a, nw, depth = kern.level_drain(state.status, lv, watermark)
            return a, nw, rounds, depth

    def plain():
        lv, rounds = (drk.level_assign_ell_plain if ell
                      else drk.level_assign_dense_plain)(state)
        a, nw, depth = drk.level_drain_plain(state.status, lv, watermark)
        return a, nw, rounds, depth

    return (run, plain, None,
            *level_work(torch, drk, state, 2 * n + 8))


def logsq_tile_pairs(torch, step, squarings: int) -> int:
    """The (128 x 128 output tile, 256-bit k-chunk) pairs whose row words
    and column words are both non-zero, summed over the squarings of the
    0/1 step matrix: the products K9's input needs (its blocks skip the
    other pairs; a dense input meets every pair).  The closure sequence
    is the plain one, s <- s | (s.s > 0), in fp32 (exact for 0/1 counts
    below 2^24), N padded with zeros to a multiple of 256."""
    n = step.shape[0]
    npad = -(-n // 256) * 256
    s = torch.zeros((npad, npad), dtype=torch.float32, device=step.device)
    s[:n, :n] = step
    pairs = 0
    for _ in range(squarings):
        a = s.view(npad // 128, 128, npad // 256, 256).amax(dim=(1, 3)) > 0
        b = s.view(npad // 256, 256, npad // 128, 128).amax(dim=(1, 3)) > 0
        pairs += int((a.sum(0) * b.sum(1)).sum())
        s = ((s @ s > 0) | (s > 0)).float()
    return pairs


def logsq_case(torch, kern, drk, state):
    """K9 log-squaring.  Bytes: one drain's (the adjacency of the Stable
    rows, read once); operations: 2 x 128 x 128 x 256 for each (output
    tile, k-chunk) pair that this input's squarings meet with non-zero
    operands (``logsq_tile_pairs``; squarings x 2 N^3 on a dense input),
    at the int8 tensor-core rate.  The library call squares the fp16 0/1
    step matrix with torch.matmul (> 0.5) as many times as the kernel
    does."""
    n = state.status.shape[0]
    sq = int(drk.drain_dense_logsq_plain(state)[2])
    stable = state.status == drk.SLOT_STABLE
    step = (drk.blocking_matrix(state) & stable[None, :]).to(torch.float16)
    pairs = logsq_tile_pairs(torch, step, sq)

    def run_library():
        s = step
        for _ in range(sq):
            s = ((torch.matmul(s, s) > 0.5) | (s > 0.5)).to(torch.float16)
        return s

    nbytes, _ops = level_work(torch, drk, state, 2 * n + 4)
    return (lambda: kern.logsq_dense(state),
            lambda: drk.drain_dense_logsq_plain(state), run_library,
            nbytes, pairs * 2 * 128 * 128 * 256, TENSOR_INT8_OPS)


def logsq_dense_input(convert, dev, n, seed=21):
    """A K9 input whose every (tile, k-chunk) pair is non-zero from the
    first squaring: Stable rows with 8 random edges each (cycles
    included) and awaits_all, so every edge gates; 4 rows Applied."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), bool)
    adj[np.repeat(np.arange(n), 8), rng.integers(0, n, 8 * n)] = True
    status = np.full(n, 4, np.int32)
    status[rng.integers(0, n, 4)] = 5
    return convert.tables_from_numpy({"drain": (
        adj, status, np.arange(n, dtype=np.int64), np.zeros(n, np.int64),
        np.ones(n, np.int32), np.ones(n, bool))}, dev)["drain"]


def logsq_simt_ms(n: int, squarings: int) -> float:
    """The bound of K9's earlier SIMT design: N^2 x ceil(N/32)
    32-bit AND/OR pairs a squaring (one LOP3 each) at the logic rate."""
    return squarings * n * n * -(-n // 32) / LOGIC_OPS * 1e3


def degree_case(torch, kern, drk, adj):
    """K10: the adjacency read once."""
    n = adj.shape[0]
    return (lambda: kern.dense_degree(adj),
            lambda: drk._dense_degree_plain(adj),
            lambda: torch.count_nonzero(adj, dim=1), n * n + 4, n * n)


def to_ell_case(torch, kern, drk, adj, d, launch=False):
    """K10: the adjacency read once, the ELL rows written.  ``launch``:
    the same kernel through ``kernels._launch`` (the generic launcher),
    to time against the wrapper's ``_launch_packed``."""
    n = adj.shape[0]

    def generic():
        out = torch.empty((n, d), dtype=torch.int32, device=adj.device)
        kern._launch("dense_to_ell", adj.device, [adj, out], [n, d])
        return out

    return (generic if launch else lambda: kern.dense_to_ell(adj, d),
            lambda: drk.dense_to_ell_plain(adj, d), None, n * n + n * d * 4,
            n * n)


def to_ell_edge_cases(torch, kern, drk, dev) -> dict:
    """K10 at the edges of its row walk: N of 1, 17, 31, 45, 300 and
    4,097 (rows that do not start on a 16-byte chunk, fewer than a warp's
    chunks), a matrix that starts 7 bytes into a chunk, d of 1, 4, 8 and
    64 (d > N), and rows with 0, d - 1, d, d + 1 and N deps and one whose
    only dep is its last byte."""
    out = {}
    for n in (1, 17, 31, 45, 300, 4097):
        for d in (1, 4, 8, 64):
            rng = np.random.default_rng(900 + n + d)
            adj = np.zeros((n, n), bool)
            for i, c in enumerate((0, d - 1, d, d + 1, n, -1)):
                if i >= n:
                    break
                if c == -1:
                    adj[i, n - 1] = True
                elif c > 0:
                    adj[i, rng.choice(n, min(c, n), replace=False)] = True
            if n > 6:
                adj[6:] = rng.random((n - 6, n)) < 3.0 / n
            flat = torch.zeros(n * n + 7, dtype=torch.bool, device=dev)
            flat[7:] = torch.from_numpy(adj.reshape(-1)).to(dev)
            for tag, a in (("", flat[7:].view(n, n).clone()),
                           (" at +7", flat[7:].view(n, n))):
                out[f"dense_to_ell[n{n} d={d}{tag}]"] = to_ell_case(
                    torch, kern, drk, a, d)
    return out


def ell_frontier_edge_cases(torch, kern, drk, convert, dev) -> dict:
    """K4a and K6 ELL at their row walk's edges: D = 1, 3, 4, 8, 32, 33
    and 64 (one to 16 chunks of a row's edges, a chunk cut short) on 300
    rows, a whole number of no CTA's rows, with rows of every status,
    ``awaits_all`` rows and -1 edges mid-row; K6 ELL on members of
    unequal n and d (one of 0 rows) and on 130 members (two launches);
    both into pinned and device ``out``."""
    cases = {}
    ells = {d: convert.tables_from_numpy({"ell": odd_ell(700 + d, 300, d)},
                                         dev)["ell"]
            for d in (1, 3, 4, 8, 32, 33, 64)}
    for d, st in ells.items():
        cases[f"frontier_ell[n300 d{d}]"] = ell_case(torch, kern, drk, st)
    group = [convert.tables_from_numpy({"ell": odd_ell(760 + k, n, d)},
                                       dev)["ell"]
             for k, (n, d) in enumerate(((37, 3), (300, 64), (1, 1),
                                         (100, 8), (45, 33), (0, 4)))]
    cases["fused_frontier_ell[37x3,300x64,1x1,100x8,45x33,0x4]"] = \
        fused_frontier_case(torch, kern, drk, group)
    rng = np.random.default_rng(37)
    many = [convert.tables_from_numpy(
        {"ell": odd_ell(800 + k, int(n), int(d))}, dev)["ell"]
        for k, (n, d) in enumerate(zip(
            rng.integers(1, 60, 130),
            rng.choice([1, 2, 3, 4, 5, 8, 16, 17, 32, 33, 64], 130)))]
    cases["fused_frontier_ell[130 members]"] = fused_frontier_case(
        torch, kern, drk, many)
    if dev.type == "cuda" and ell_out(kern):
        for out in ("pinned", "device"):
            for d in (3, 8, 33):
                cases[f"frontier_ell[n300 d{d} {out}]"] = ell_case(
                    torch, kern, drk, ells[d], out=out)
            cases[f"fused_frontier_ell[unequal {out}]"] = \
                fused_frontier_case(torch, kern, drk, group, out=out)
            cases[f"fused_frontier_ell[130 members {out}]"] = \
                fused_frontier_case(torch, kern, drk, many, out=out)
    return cases


def drain_cases(torch, kern, drk, tag, dense, ell):
    """Every K8-K10 kernel on one dense state and its ELL twin; the
    log-depth drains (K7 with K9's epilogue) on both, with and without a
    watermark (an int, a 0-d int64 and a 0-d int32 tensor on the card)."""
    w64 = torch.tensor(2, device=ell.status.device)
    w32 = torch.tensor(1, dtype=torch.int32, device=ell.status.device)
    return {
        f"drain_fix_dense[{tag}]": fix_case(torch, kern, drk, dense),
        f"drain_fix_ell[{tag}]": fix_case(torch, kern, drk, ell),
        f"logsq_dense[{tag}]": logsq_case(torch, kern, drk, dense),
        f"level_drain[{tag} ell]": level_drain_case(torch, kern, drk, ell),
        f"level_drain[{tag} dense]": level_drain_case(torch, kern, drk,
                                                      dense),
        f"level_drain[{tag} ell w=2]": level_drain_case(torch, kern, drk,
                                                        ell, 2),
        f"level_drain[{tag} dense w=2]": level_drain_case(torch, kern, drk,
                                                          dense, 2),
        f"level_drain[{tag} ell w=2 i64]": level_drain_case(
            torch, kern, drk, ell, w64),
        f"level_drain[{tag} dense w=1 i32]": level_drain_case(
            torch, kern, drk, dense, w32),
        f"dense_degree[{tag}]": degree_case(torch, kern, drk, dense.adj),
        f"dense_to_ell[{tag} d=4]": to_ell_case(torch, kern, drk, dense.adj,
                                                4),
        f"dense_to_ell[{tag} d=8]": to_ell_case(torch, kern, drk, dense.adj,
                                                8)}


def chain_states(convert, dev, n):
    """A serial chain of ``n`` Stable rows (head applied), dense and ELL."""
    idx = np.full((n, 4), -1, np.int32)
    idx[1:, 0] = np.arange(n - 1)
    adj = np.zeros((n, n), bool)
    adj[np.arange(1, n), np.arange(n - 1)] = True
    st = np.full(n, 4, np.int32)
    st[0] = 5
    cols = (st, np.arange(n, dtype=np.int64), np.zeros(n, np.int64),
            np.ones(n, np.int32), np.zeros(n, bool))
    out = convert.tables_from_numpy({"drain": (adj,) + cols,
                                     "ell": (idx,) + cols}, dev)
    return out["drain"], out["ell"]


def time_ms(torch, fn, on_cuda: bool, reps: int = 15, warm: int = 3):
    """Median ms of ``fn`` after warm-up: CUDA events around each call on
    the card, the host clock in a CPU rehearsal."""
    for _ in range(warm):
        fn()
    if not on_cuda:
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def logic_rate(torch, dev) -> float:
    """32-bit integer instructions per second on this card: its SMs x 64
    INT32 lanes x its maximum SM clock (``nvidia-smi`` clocks.max.sm)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
            capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0])
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        fail("nvidia-smi did not report the maximum SM clock")
    return sms * 64 * mhz * 1e6


def run_checks(torch, cases: dict, label: str, on_cuda: bool,
               timed: bool) -> dict:
    """Each case: kernel vs plain on the same inputs, byte-equal."""
    out = {}
    for name, case in cases.items():
        kfn, pfn, lfn, nbytes, ops = case[:5]
        # operations per second of the work a case counts: the scalar
        # logic rate unless the case names another (a tensor-core rate);
        # a case that uploads its inputs names the bytes it sends over the
        # host link
        peak = case[5] if len(case) > 5 else LOGIC_OPS
        link_bytes = case[6] if len(case) > 6 else 0
        got = kfn()
        if on_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pfn()
        if on_cuda:
            torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        # a plain version that loops on the host (a fixpoint's thousands
        # of sweeps) is timed with fewer repetitions, and one that takes
        # seconds by the call above
        reps, warm = (15, 3) if plain_s < 0.2 else (3, 1)
        err = _max_abs_err(torch, got, want)
        check(err == 0, f"{label} {name}: kernel != plain (max_abs_err "
                        f"{err}) {_diff_report(torch, got, want)}")
        row = {"max_abs_err": err}
        if timed:
            row["ms"] = time_ms(torch, kfn, on_cuda)
            row["plain_ms"] = (plain_s * 1e3 if plain_s > 2.0 else
                               time_ms(torch, pfn, on_cuda, reps, warm))
            row["library_ms"] = (time_ms(torch, lfn, on_cuda)
                                 if lfn is not None else None)
            t_bytes = max(nbytes / HBM_BPS, link_bytes / PCIE_BPS) * 1e3
            if callable(ops):     # a count of what this run's data needs
                ops, notes = ops()
                row.update(notes)
                row["bound_formula_ms"] = max(
                    t_bytes, notes["ops_formula"] / peak * 1e3)
            t_ops = ops / peak * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            row["bytes"] = int(nbytes)
            row["ops"] = int(ops)
            if link_bytes:
                row["link_bytes"] = int(link_bytes)
                row["link_ms"] = link_bytes / PCIE_BPS * 1e3
        out[name] = row
        log(f"check {label} {name}: equal " + json.dumps(row))
    return out


def small_cases(torch, dev, kern, dk, drk, convert):
    cases = {}
    for seed, wide in ((1, False), (2, True)):
        inp = small_inputs(seed, dk)
        up = convert.tables_from_numpy(
            {"table": inp["table"], "buckets": inp["buckets"],
             "attr": inp["attr"], "aidx": inp["aidx"]}, dev)
        qb = torch.from_numpy(inp["qmat_b"]).to(dev)
        qd = torch.from_numpy(inp["qmat"]).to(dev)
        rankb = torch.from_numpy(inp["rankb"]).to(dev)
        m, m_t = inp["m"], inp["m_t"]
        for s, k in ((8192, 64), (40, 3)):     # the second overflows
            tag = f"[seed{seed}{' i64' if wide else ''} s{s}]"
            cases["deps_bucketed" + tag] = bucket_case(
                torch, kern, dk, m_t, up["buckets"], qb, m, 4, s, k,
                inp["prune"], 8, wide)
            cases["deps_dense" + tag] = dense_case(
                torch, kern, dk, up["table"], qd, m, s, k, inp["prune"],
                wide)
            hdr, ent = dk.bucketed_flat_plain(m_t, up["buckets"], qb, m, 4,
                                              s, k, inp["prune"], 16, wide)
            for floors, elide in ((True, True), (False, False)):
                cases[f"attr_post{tag}[{floors:d}{elide:d}]"] = attr_case(
                    torch, kern, dk, up["table"].lo, up["attr"], up["aidx"],
                    rankb, hdr, ent, m_t, m, floors, elide)
        rows = np.array([3, 17, 40, 40, 40], np.int32)
        src = small_inputs(seed + 10, dk)["table"]
        cases[f"scatter_rows[seed{seed}]"] = scatter_case(
            torch, kern, dk, list(up["table"]), rows, [a[rows] for a in src])
    cases.update(scatter_edge_cases(torch, kern, dk, dev))
    cases.update(dense_edge_cases(torch, kern, dk, convert, dev))
    cases.update(bucket_edge_cases(torch, kern, dk, convert, dev))
    cases.update(fix_edge_cases(torch, kern, drk, convert, dev))
    cases.update(fix_ell_edge_cases(torch, kern, drk, convert, dev))
    cases.update(to_ell_edge_cases(torch, kern, drk, dev))
    cases.update(ell_frontier_edge_cases(torch, kern, drk, convert, dev))
    # rows with more candidates than shared memory holds (C > 4096) sort
    # in global scratch: 8 intervals x 4 probes x 128 entries + the wide list
    for seed, wide in ((6, False), (7, True)):
        inp = small_inputs(seed, dk, m=8, kb=128)
        up = convert.tables_from_numpy({"buckets": inp["buckets"]}, dev)
        qb = torch.from_numpy(inp["qmat_b"]).to(dev)
        tag = f"[seed{seed}{' i64' if wide else ''} C>{kern.SMEM_CODES}]"
        cases["deps_bucketed" + tag] = bucket_case(
            torch, kern, dk, inp["m_t"], up["buckets"], qb, inp["m"], 4,
            8192, 256, inp["prune"], 128, wide)
    drains = []
    for seed, n in ((3, 64), (4, 512), (8, 48)):
        dense, ell = small_drain(seed, n)
        st = convert.tables_from_numpy({"drain": dense, "ell": ell}, dev)
        drains.append(st)
        cases[f"frontier_dense[n{n}]"] = dense_frontier_case(
            torch, kern, drk, st["drain"])
        cases[f"frontier_ell[n{n}]"] = ell_case(torch, kern, drk, st["ell"])
        cases[f"level_dense[n{n}]"] = level_case(torch, kern, drk,
                                                 st["drain"])
        cases[f"level_ell[n{n}]"] = level_case(torch, kern, drk, st["ell"])
        cases.update(drain_cases(torch, kern, drk, f"n{n}", st["drain"],
                                 st["ell"]))
    # K4b planned, on rows that end inside a 16-byte chunk
    for seed, n in ((9, 200), (10, 1000)):
        st = convert.tables_from_numpy({"drain": small_drain(seed, n)[0]},
                                       dev)["drain"]
        cases[f"frontier_dense[n{n} planned]"] = dense_frontier_case(
            torch, kern, drk, kern.checked_cols(st))
    # K6 on unequal members: pad rows, pad edges
    cases["fused_frontier_dense[64,512,48]"] = fused_frontier_case(
        torch, kern, drk, [st["drain"] for st in drains])
    cases["fused_frontier_ell[64,512,48]"] = fused_frontier_case(
        torch, kern, drk, [st["ell"] for st in drains])
    # K6 dense on members whose n is not a multiple of 16 and a member of
    # one row, into a pinned host buffer (the tick's form) too; and on
    # 130 members, past the 128 a launch takes by value
    odd = [convert.tables_from_numpy({"drain": small_drain(seed, n)[0]},
                                     dev)["drain"]
           for seed, n in ((31, 1), (32, 37), (33, 100), (34, 17))]
    cases["fused_frontier_dense[1,37,100,17]"] = fused_frontier_case(
        torch, kern, drk, odd)
    if dev.type == "cuda":
        cases["fused_frontier_dense[1,37,100,17 tick]"] = \
            fused_frontier_case(torch, kern, drk, odd, tick=True)
    sizes = np.random.default_rng(35).integers(1, 90, 130)
    cases["fused_frontier_dense[130 members]"] = fused_frontier_case(
        torch, kern, drk, [convert.tables_from_numpy(
            {"drain": small_drain(400 + k, int(n))[0]}, dev)["drain"]
            for k, n in enumerate(sizes)])
    # K7 dense at its edges: more than 32 deps a row, lists past their
    # regions, N not a multiple of 16, a cycle, all blocked, the first
    # CTA's cap
    for tag, g in level_graphs(dev.type == "cuda").items():
        cases[f"level_dense[{tag}]"] = level_case(
            torch, kern, drk, convert.tables_from_numpy({"drain": g},
                                                        dev)["drain"])
    # K7 ELL at its edges: either side of the first CTA's caps, D = 1 and
    # 33, a cycle, all blocked, all Stable at 131,072 rows (the grid)
    for tag, g in level_ell_graphs(dev.type == "cuda").items():
        cases[f"level_ell[{tag}]"] = level_case(
            torch, kern, drk, convert.tables_from_numpy({"ell": g},
                                                        dev)["ell"])
    # K7 on a deep chain: logarithmic rounds, exact levels
    dchain, echain = chain_states(convert, dev, 1024)
    cases["level_dense[chain1024]"] = level_case(torch, kern, drk, dchain)
    cases["level_ell[chain1024]"] = level_case(torch, kern, drk, echain)
    cases.update(drain_cases(torch, kern, drk, "chain1024", dchain, echain))
    # K9 at the edges of its tiling: one row,
    # either side of a 32-bit word and of a 128-row tile, a prime, and
    # 4,097 (one past a 256-bit k-chunk: 255 padded rows and columns),
    # random and as a 4,097-deep chain (13 squarings); the card only
    sizes = ((11, 1), (12, 31), (13, 33), (14, 127), (15, 129), (16, 1009))
    if dev.type == "cuda":
        sizes += ((17, 4097),)
    logsq_states = [(f"n{n}", convert.tables_from_numpy(
        {"drain": small_drain(seed, n)[0]}, dev)["drain"])
        for seed, n in sizes]
    if dev.type == "cuda":
        logsq_states.append(("chain4097",
                             chain_states(convert, dev, 4097)[0]))
    for tag, st in logsq_states:
        cases[f"logsq_dense[{tag}]"] = logsq_case(torch, kern, drk, st)
    # K5 on unequal members (capacities and interval widths), int32 and
    # int64 codes, every leg switch, and budgets that overflow
    for seed, wide, shapes in ((5, False, ((256, 4), (96, 2), (160, 8))),
                               (9, True, ((128, 4), (128, 4)))):
        ins = [small_inputs(seed * 10 + i, dk, n=n, m_t=m_t, b=16)
               for i, (n, m_t) in enumerate(shapes)]
        ups = [convert.tables_from_numpy(
            {"table": x["table"], "attr": x["attr"], "aidx": x["aidx"]}, dev)
            for x in ins]
        tables = [u["table"] for u in ups]
        qmats = torch.from_numpy(np.stack([x["qmat"] for x in ins])).to(dev)
        rankbs = torch.from_numpy(np.stack([x["rankb"] for x in ins])).to(dev)
        prunes = tuple(np.array([x["prune"][c] for x in ins], np.int64)
                       for c in range(3))
        for s, k in ((8192, 64), (40, 3)):
            tag = f"[seed{seed}{' i64' if wide else ''} s{s}]"
            cases["fused_deps_dense" + tag] = fused_scan_case(
                torch, kern, dk, tables, qmats, prunes, 4, s, k, wide)
            hdr, ent = dk.fused_flat_csr_plain(tables, qmats, prunes, 4, s,
                                               k, wide)
            for floors, elide in ((True, True), (False, True),
                                  (True, False)):
                cases[f"fused_attr_post{tag}[{floors:d}{elide:d}]"] = \
                    fused_attr_case(torch, kern, dk, tables,
                                    [u["attr"] for u in ups],
                                    [u["aidx"] for u in ups], rankbs, hdr,
                                    ent, 4, floors, elide)
    cases.update(fused_edge_cases(torch, kern, dk, convert, dev))
    return cases


# -- the real-size store (bench.py's headline workload, ported) ----------------

def build_workload(rng, n, keyspace, max_iv, P):
    hlcs = rng.choice(np.arange(1, 4_000_000), size=n, replace=False)
    out = []
    for i in range(n):
        point = rng.random() < 0.5
        kind = P.TxnKind.Write if rng.random() < 0.7 else P.TxnKind.Read
        tid = P.TxnId.create(1, int(hlcs[i]), kind,
                             P.Domain.Key if point else P.Domain.Range,
                             int(rng.integers(1, 6)))
        toks, rngs = [], []
        for _ in range(int(rng.integers(1, max_iv + 1))):
            if point:
                toks.append(int(rng.integers(0, keyspace)))
            else:
                s = int(rng.integers(0, keyspace - 64))
                rngs.append(P.Range(s, s + int(rng.integers(1, 64))))
        out.append((tid, toks, rngs))
    return out


def make_queries(seed, k, keyspace, max_iv, P, wide_frac=0.0):
    """bench.make_queries, plus an optional share of wide range queries
    (spanning more buckets than the index probes: the dense route)."""
    qrng = np.random.default_rng(seed)
    qs = []
    for _ in range(k):
        bound = P.TxnId.create(1, int(qrng.integers(4_000_000, 5_000_000)),
                               P.TxnKind.Write, P.Domain.Key, 1)
        toks, rngs = [], []
        if qrng.random() < wide_frac:
            s = int(qrng.integers(0, keyspace - 4096))
            rngs.append(P.Range(s, s + int(qrng.integers(512, 4096))))
        else:
            for _ in range(int(qrng.integers(1, max_iv + 1))):
                if qrng.random() < 0.5:
                    toks.append(int(qrng.integers(0, keyspace)))
                else:
                    s = int(qrng.integers(0, keyspace - 64))
                    rngs.append(P.Range(s, s + int(qrng.integers(1, 64))))
        qs.append((bound, bound, bound.kind().witnesses(), toks, rngs))
    return qs


class P:
    """The port's primitives, imported once the package is known to load."""

    @classmethod
    def load(cls):
        from accord_tpu_torch.local.commands_for_key import (CommandsForKey,
                                                             InternalStatus)
        from accord_tpu_torch.local.device_index import DeviceState
        from accord_tpu_torch.local.dispatch import DeviceDispatcher
        from accord_tpu_torch.local.redundant import RedundantBefore
        from accord_tpu_torch.ops.packing import pack_timestamps
        from accord_tpu_torch.primitives.deps import DepsBuilder
        from accord_tpu_torch.primitives.keys import (IntKey, Keys, Range,
                                                      Ranges)
        from accord_tpu_torch.primitives.timestamp import (Domain, TxnId,
                                                           TxnKind)
        for k, v in list(locals().items()):
            if k != "cls":
                setattr(cls, k, v)


class Store:
    def __init__(self):
        self.commands_for_key = {}
        self.redundant_before = P.RedundantBefore()

    class node:
        scheduler = None


class Safe:
    def __init__(self, store):
        self.store = store

    def redundant_before(self):
        return self.store.redundant_before


def build_store(entries, keyspace, device):
    store = Store()
    floor_id = P.TxnId.create(1, 500_000, P.TxnKind.ExclusiveSyncPoint,
                              P.Domain.Range, 1)
    store.redundant_before.add_redundant(
        P.Ranges.of(*(P.Range(s, s + 50_000)
                      for s in range(0, keyspace // 2, 100_000))), floor_id)
    dev = P.DeviceState(store, device=device)
    register(dev, store, entries)
    return store, dev, Safe(store)


def register(dev, store, entries):
    for tid, toks, rngs in entries:
        keys = (P.Ranges.of(*rngs) if rngs
                else P.Keys([P.IntKey(t) for t in toks]))
        dev.register(tid, int(P.InternalStatus.PREACCEPTED), keys)
        for t in toks:
            cfk = store.commands_for_key.get(t)
            if cfk is None:
                cfk = store.commands_for_key[t] = P.CommandsForKey(t)
            cfk.update(tid, P.InternalStatus.PREACCEPTED)


def deps_digest(builders):
    out = []
    for b in builders:
        d = b.build()
        out.append(([(k, [(t.msb, t.lsb, t.node)
                          for t in d.key_deps.txn_ids_for(k)])
                     for k in d.key_deps.keys.tokens()],
                    [(r.start, r.end,
                      [(d.range_deps.txn_ids[j].msb,
                        d.range_deps.txn_ids[j].lsb,
                        d.range_deps.txn_ids[j].node) for j in row])
                     for r, row in zip(d.range_deps.ranges,
                                       d.range_deps._per_range)]))
    return out


def attributed(dev, safe, batch):
    builders = [P.DepsBuilder() for _ in batch]
    dev.deps_query_batch_attributed(safe, batch, builders)
    return builders


def _work(name, a):
    """Size of one recorded call, to keep the largest the path gives."""
    if name == "deps_bucketed":
        return a[2].shape[0]
    if name == "deps_dense":
        return a[1].shape[0] * a[0].lo.shape[0]
    if name == "attr_post":
        return a[5].shape[0]
    if name == "scatter_rows":
        return len(a[1]) * sum(c[0].numel() * c.element_size()
                               for c in a[0])
    if name == "fused_deps_dense":
        return a[1].shape[0] * a[1].shape[1]
    if name == "fused_attr_post":
        return a[5].numel()
    if name == "fused_flat_attr":
        return a[3].shape[0] * a[3].shape[1]
    if name.startswith("fused_frontier"):
        return sum(st.status.shape[0] for st in a[0])
    if name == "calc_deps":
        return sum(t.capacity for t in a[0]) * a[1].msb.shape[0]
    if name == "ts_max":
        return a[0].numel()
    if name == "merge_blocks":
        return len(a[0]) * len(a[0][0]) * a[2]
    if name in ("sharded_frontier", "sharded_drain", "sharded_drain_fix"):
        return len(a[0]) * a[2] * a[3]
    if name == "attr_tok":
        return len(a[0]) * a[0][0].shape[0]
    return a[0].status.shape[0]


def _copy(x):
    if hasattr(x, "clone"):
        return x.clone()
    if isinstance(x, (tuple, list)):
        items = [_copy(y) for y in x]
        if not hasattr(x, "_fields"):
            return type(x)(items)
        if getattr(x, "_plan", None) is None:
            return type(x)(*items)
        # a column set a mirror planned: its copy is planned too, so that
        # a recorded call takes the main path's host path
        from accord_tpu_torch.ops import kernels
        return kernels.checked_cols(type(x)(*items))
    return x


class Recorder:
    """Wrap the kernel entry points ``names`` to keep, for each, a copy of
    the arguments of its largest call (the shapes and data the main path
    gives the kernel; a copy, since later scatters write in place)."""

    def __init__(self, kern, names=None):
        self.kern = kern
        self.calls = {}
        self.orig = {n: getattr(kern, n) for n in (names or kern.KERNELS)}
        for name, fn in self.orig.items():
            setattr(kern, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            w = _work(name, a)
            if name not in self.calls or w > self.calls[name][2]:
                self.calls[name] = (_copy(a), kw, w)
            return fn(*a, **kw)
        return wrapped

    def restore(self):
        for name, fn in self.orig.items():
            setattr(self.kern, name, fn)


class MedianRecorder(Recorder):
    """A Recorder that keeps a copy of every call of ``names``, so that a
    run can be timed at its median call (by ``_work``) as well as its
    largest."""

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            self.calls.setdefault(name, []).append(
                (_copy(a), kw, _work(name, a)))
            return fn(*a, **kw)
        return wrapped

    def median(self, name):
        """(args, kwargs, work, number of calls) of the median call."""
        calls = sorted(self.calls[name], key=lambda c: c[2])
        return calls[len(calls) // 2] + (len(calls),)


class ScatterSizes:
    """Wrap K3's wrapper to note the payload of each call the main path
    makes: the packed staging buffer's bytes of a live call (numpy in),
    the rows' bytes of a call handed tensors."""

    def __init__(self, torch, kern, dk):
        self.kern, self.real = kern, kern.scatter_rows
        self.live, self.tensor = [], []

        def wrapped(cols, idx, rows):
            if torch.is_tensor(idx):
                self.tensor.append(len(idx) * sum(dk.row_bytes(c)
                                                  for c in cols))
            elif len(idx):
                self.live.append(dk.pack_layout(cols, len(idx))[1])
            return self.real(cols, idx, rows)
        kern.scatter_rows = wrapped

    def restore(self):
        self.kern.scatter_rows = self.real

    def summary(self, threshold: int) -> dict:
        live = sorted(self.live)
        return {"live_calls": len(live),
                "live_at_least_pool_threshold": sum(b >= threshold
                                                    for b in live),
                "pool_threshold_bytes": threshold,
                "live_bytes_median": live[len(live) // 2] if live else 0,
                "live_bytes_max": live[-1] if live else 0,
                "live_bytes_total": sum(live),
                "tensor_calls": len(self.tensor)}


class DenseTickTimes:
    """Each solo dense drain tick's ``drain_tick_dispatch`` and
    ``drain_tick_wait`` (``DeviceState._ktime_span``), told apart from the
    other ticks by its K4b call; and how many dense drain states the
    mirrors built (``_DrainMirror._cache_state``) meanwhile."""

    def __init__(self, kern, cls, mirror, drk):
        self.kern, self.cls, self.mirror = kern, cls, mirror
        self.k4b, self.span = kern.frontier_dense, cls._ktime_span
        self.cache = mirror._cache_state
        self.pending = False
        self.dispatch, self.wait = [], []
        self.built = 0
        outer = self

        def cache(m, state, *a):
            outer.built += isinstance(state, drk.DrainState)
            return outer.cache(m, state, *a)
        mirror._cache_state = cache

        def k4b(*a, **kw):
            outer.pending = True
            return outer.k4b(*a, **kw)

        def span(dev, kind, t0, t1):
            if outer.pending and kind == "drain_tick_dispatch":
                outer.dispatch.append(t1 - t0)
            elif outer.pending and kind == "drain_tick_wait":
                outer.wait.append(t1 - t0)
                outer.pending = False
            return outer.span(dev, kind, t0, t1)
        kern.frontier_dense = k4b
        cls._ktime_span = span

    def restore(self):
        self.kern.frontier_dense = self.k4b
        self.cls._ktime_span = self.span
        self.mirror._cache_state = self.cache

    def summary(self) -> dict:
        both = [d + w for d, w in zip(self.dispatch, self.wait)]
        med = (lambda x: statistics.median(x) * 1e3 if x else None)
        return {"ticks": len(both), "dense_states_built": self.built,
                "dispatch_ms_p50": med(self.dispatch),
                "wait_ms_p50": med(self.wait),
                "dispatch_plus_wait_ms_p50": med(both)}


class DrainRecord:
    """The fields of a command that DeviceState.arm and the drain tick's
    host re-check read.  ``save_status`` is None, so the protocol's re-check
    (commands.refresh_waiting_and_maybe_execute) leaves every proposed txn
    waiting: the protocol's execution is phase 6's.  A DrainStore in apply
    mode executes proposed txns itself (DrainSafe)."""
    save_status = None

    def __init__(self, execute_at, deps):
        self.execute_at = execute_at
        self.waiting_on = self
        self.deps = deps

    def waiting_ids(self):
        return self.deps


class DrainStore(Store):
    """A store whose drain ticks run when the script says: the tick that
    DeviceState.schedule_tick hands the node's scheduler is kept until
    ``run_ticks`` and then runs through ``execute``, as the store's task
    queue runs it.  ``proposed`` collects the txns each tick proposed.

    With ``apply`` set, the store plays the protocol's execution: a
    proposed txn whose gating dependencies have all applied (the WaitingOn
    re-check, over the drain mirror) applies at once — its drain row goes
    Applied, it stops being driven, and a tick is scheduled, as
    DeviceState.update_status does for an applied txn."""

    def __init__(self):
        super().__init__()
        self.records = {}
        self.proposed = set()
        self.due = []
        self.node = self
        self.scheduler = self
        self.dispatcher = None
        self.ticks = []
        self.ds = None
        self.apply = False
        self.applied = []

    def try_apply(self, txn_id) -> None:
        ds = self.ds
        dr = ds.drain
        i = dr.slot_of.get(txn_id)
        if i is None or int(dr.status[i]) != 4 or not dr.active[i]:
            return
        m64 = (1 << 64) - 1

        def ex(s):
            return (int(dr.exec_msb[s]) & m64, int(dr.exec_lsb[s]) & m64,
                    int(dr.exec_node[s]))
        for j in dr.deps_of[i]:
            sj = int(dr.status[j])
            if sj in (-1, 5, 6):          # free, applied, invalidated
                continue
            if sj < 3 or dr.awaits_all[i] or ex(j) < ex(i):
                return                    # a gating dep has not applied
        dr.set_status(i, 5, self.records[txn_id].execute_at)
        ds.on_driven(txn_id)
        self.applied.append(txn_id)
        ds.schedule_tick()

    def run_until_idle(self, limit: int) -> int:
        """Run ticks until none is due; the number of ticks run."""
        n = 0
        while self.due and n < limit:
            n += len(self.due)
            self.run_ticks()
        return n

    def once(self, _delay, fn):
        self.due.append(fn)

    def execute(self, _ctx, fn):
        fn(DrainSafe(self))

    def drain_observer(self, _store, mode, n):
        self.ticks.append((mode, n))

    def run_ticks(self):
        self.proposed = set()
        due, self.due = self.due, []
        for fn in due:
            fn()


class DrainSafe(Safe):
    def if_present(self, txn_id):
        self.store.proposed.add(txn_id)   # the tick asks for candidates only
        if self.store.apply:
            self.store.try_apply(txn_id)
        return self.store.records.get(txn_id)


def add_chain(store, ds, depth, hlc0):
    """Arm a ``depth``-deep serial chain of Stable txns in ``store`` (each
    waits on the one before; executeAt ascending); returns its ids."""
    safe = DrainSafe(store)
    ids = [P.TxnId.create(1, hlc0 + i, P.TxnKind.Write, P.Domain.Key, 1)
           for i in range(depth)]
    for i, tid in enumerate(ids):
        store.records[tid] = DrainRecord(tid, [ids[i - 1]] if i else [])
        ds.arm(safe, tid)
    return ids


def chain_store(depth, device, mesh=None):
    """bench.py config 3's serial chain (NDD deep) alone in a store: its
    live set fits the dense drain form."""
    store = DrainStore()
    ds = P.DeviceState(store, device=device, mesh=mesh)
    store.ds = ds
    return store, ds, add_chain(store, ds, depth, 10)


class TickNode:
    """A node whose DeviceDispatcher coalesces drain stores' ticks: the
    stores' ticks register with it and run on its event loop."""
    node_id = 1
    alive = True

    def __init__(self):
        self.scheduler = Sched()
        self.dispatcher = P.DeviceDispatcher(self)

    @staticmethod
    def drain_observer(store, mode, n):
        store.ticks.append((mode, n))


# -- config 5's harness: many stores, small flushes, one dispatcher -----------

class Sched:
    """A FIFO event loop: ``now`` and ``once`` enqueue, ``run`` drains."""

    def __init__(self):
        self.q = []

    def now(self, fn):
        self.q.append(fn)

    def once(self, _delay, fn):
        self.q.append(fn)

    def run(self):
        while self.q:
            self.q.pop(0)()


class LaunchNode:
    """One node: the event loop and its DeviceDispatcher."""
    node_id = 1
    alive = True

    def __init__(self, fusion=None):
        self.scheduler = Sched()
        self.dispatcher = P.DeviceDispatcher(self)
        if fusion is not None:          # None: ACCORD_TPU_FUSION decides
            self.dispatcher.fusion = fusion


class LaunchShim:
    """The store surface the dispatcher and its harvest tasks touch: the
    store id that orders members, and ``execute`` onto the node's loop."""

    def __init__(self, inner, node, sid):
        self.node = node
        self.store_id = sid
        self.commands_for_key = inner.commands_for_key
        self.redundant_before = inner.redundant_before

    def execute(self, _ctx, fn):
        shim = self

        class _Safe:
            store = shim

            @staticmethod
            def redundant_before():
                return shim.redundant_before

        self.node.scheduler.now(lambda: fn(_Safe()))


def launch_harness(stores, nper, keys, fusion, device, seed=21):
    """bench.py config 5 (``bench_launch_amortized_harness``): ``stores``
    DeviceStates of ``nper`` in-flight single-key writes over ``keys`` keys
    on ONE node's DeviceDispatcher, every store on the dense route.
    Returns (node, devs)."""
    rng = np.random.default_rng(seed)
    node = LaunchNode(fusion)
    devs = []
    for sid in range(stores):
        inner = Store()
        dev = P.DeviceState(inner, device=device)
        dev.store = LaunchShim(inner, node, sid)
        dev.route_override = "dense"
        hlcs = rng.choice(np.arange(1, 1_000_000), size=nper, replace=False)
        for i in range(nper):
            tid = P.TxnId.create(1, int(hlcs[i]), P.TxnKind.Write,
                                 P.Domain.Key, 1 + i % 5)
            dev.register(tid, int(P.InternalStatus.PREACCEPTED),
                         P.Keys([P.IntKey(int(rng.integers(0, keys)))]))
        devs.append(dev)
    return node, devs


def drive_flushes(node, devs, rounds, keys, seed, per=4):
    """``rounds`` rounds of ``per`` single-key deps queries per store, all
    runnable in the same event-loop step; returns each store's builders."""
    rng = np.random.default_rng(seed)
    out = [[] for _ in devs]
    failures = []

    def done(failure, _safe):
        if failure is not None:
            failures.append(failure)

    for _r in range(rounds):
        for i, dev in enumerate(devs):
            for _ in range(per):
                bound = P.TxnId.create(
                    1, int(rng.integers(1_000_000, 2_000_000)),
                    P.TxnKind.Write, P.Domain.Key, 1)
                b = P.DepsBuilder()
                out[i].append(b)
                dev.enqueue_query((bound, bound, bound.kind().witnesses(),
                                   [int(rng.integers(0, keys))], []), b,
                                  done)
        node.scheduler.run()
    if failures:
        raise failures[0]
    return out


def drain_store(nd, device, seed=11):
    """A store with ``nd`` live drain rows shaped like bench.py's config-3
    ELL drain (512 hot chains with local fan-in, degree <= 8) and mixed
    statuses, built as the protocol builds it: each Stable txn is armed
    (DeviceState.arm) with its waiting set; every other txn is a
    dependency-only row with its status, as arm's dependency lookup
    allocates it."""
    rng = np.random.default_rng(seed)
    chains, d = 512, 8
    store = DrainStore()
    ds = P.DeviceState(store, device=device)
    safe = DrainSafe(store)
    ids = [P.TxnId.create(1, 10 + i, P.TxnKind.Write, P.Domain.Key, 1)
           for i in range(nd)]
    statuses = rng.choice(np.array([4, 4, 4, 4, 5, 5, 3, 1, 6], np.int32), nd)
    for i, tid in enumerate(ids):
        st = int(statuses[i])
        if st != 4:
            slot = ds.drain.alloc(tid)
            ds.drain.set_status(slot, st, tid if st in (3, 5) else None)
            continue
        deps = []
        if i >= chains:
            deps.append(ids[i - chains])
            lo = max(0, i - 3 * chains)
            deps += [ids[int(j)] for j in
                     rng.integers(lo, i - 1, int(rng.integers(1, d)))]
        store.records[tid] = DrainRecord(tid, list(dict.fromkeys(deps)))
        ds.arm(safe, tid)
    return store, ds


# -- bench config 3 (hot keys), ported: bench.py:183-238, :427-502, :567 -------

def build_hot128_store(device, n3=100_000, b3=256, hot=128):
    """bench.build_hot128_store on the port's DeviceState: ``n3`` txns over
    ``hot`` keys, the 90% below the durable floor Applied, the rest
    Committed (30%) or PreAccepted, registered with update_status and
    CommandsForKey state, the floor over the hot keys, and ``4 * b3``
    single-key-set queries — all drawn from ``default_rng(9)`` in the
    reference's order.  Returns (store, dev, safe, queries, build_rate,
    rng), ``rng`` the stream's continuation for the drain legs."""
    IS = P.InternalStatus
    rng = np.random.default_rng(9)
    store = Store()
    dev = P.DeviceState(store, device=device)
    safe = Safe(store)
    hlcs = np.sort(rng.choice(np.arange(1, 2_000_000), size=n3,
                              replace=False))
    floor_hlc = int(hlcs[int(n3 * 0.9)])
    floor_id = P.TxnId.create(1, floor_hlc, P.TxnKind.ExclusiveSyncPoint,
                              P.Domain.Range, 1)
    entries = []
    for i in range(n3):
        hlc = int(hlcs[i])
        if hlc < floor_hlc:
            status = IS.APPLIED
        else:
            status = (IS.COMMITTED if rng.random() < 0.3
                      else IS.PREACCEPTED)
        kind = P.TxnKind.Write if rng.random() < 0.7 else P.TxnKind.Read
        tid = P.TxnId.create(1, hlc, kind, P.Domain.Key, 1 + i % 5)
        toks = [int(t) for t in rng.integers(0, hot, rng.integers(1, 4))]
        entries.append((tid, status, toks))
    t0 = time.perf_counter()
    for tid, status, toks in entries:
        dev.register(tid, int(status), P.Keys([P.IntKey(t) for t in toks]))
        if status >= IS.COMMITTED:
            dev.update_status(tid, int(status), execute_at=tid)
        for t in toks:
            cfk = store.commands_for_key.get(t)
            if cfk is None:
                cfk = store.commands_for_key[t] = P.CommandsForKey(t)
            cfk.update(tid, status,
                       execute_at=tid if status >= IS.COMMITTED else None)
    build_rate = n3 / (time.perf_counter() - t0)
    store.redundant_before.add_redundant(P.Ranges.of(P.Range(0, hot)),
                                         floor_id)
    queries = []
    for _ in range(b3 * 4):
        bound = P.TxnId.create(1, int(rng.integers(2_000_000, 3_000_000)),
                               P.TxnKind.Write, P.Domain.Key, 1)
        toks = [int(t) for t in rng.integers(0, hot, rng.integers(1, 4))]
        queries.append((bound, bound, bound.kind().witnesses(), toks, []))
    return store, dev, safe, queries, build_rate, rng


def hot_drain_legs(rng, convert, device, nd=100_000, chains=512, ndd=4096):
    """bench.py's config-3 drain legs from the rng continuation: ``nd``
    Stable txns in ``chains`` hot chains with local fan-in (ELL, degree <=
    8), and the ``ndd``-deep chain with up to 7 more deps a row (dense, and
    its ELL form at the next power-of-two width).  executeAt = TxnId(1, 10 +
    i).  Returns (ell, dense, dense_ell, ell_rows, deep_edges)."""
    d = 8
    ids = [P.TxnId.create(1, 10 + i, P.TxnKind.Write, P.Domain.Key, 1)
           for i in range(nd)]
    em, el, en = (np.asarray(x) for x in P.pack_timestamps(ids))
    adj_idx = np.full((nd, d), -1, np.int32)
    for i in range(chains, nd):
        adj_idx[i, 0] = i - chains              # chain predecessor
        extra = rng.integers(1, d, 1)[0]
        lo = max(0, i - 3 * chains)
        if lo < i - 1:
            adj_idx[i, 1:1 + extra] = rng.integers(lo, i - 1, extra)
    adj = np.zeros((ndd, ndd), bool)
    for i in range(1, ndd):
        adj[i, i - 1] = True
        for j in range(max(0, i - 8), i - 1):
            adj[i, j] = rng.random() < 0.5
    deep_edges = [np.nonzero(adj[i])[0].tolist() for i in range(ndd)]
    deg = max(1, max(len(e) for e in deep_edges))
    dd = 4
    while dd < deg:
        dd *= 2
    adj_idx_d = np.full((ndd, dd), -1, np.int32)
    for i, e in enumerate(deep_edges):
        adj_idx_d[i, :len(e)] = e

    def cols(n):
        return (np.full(n, 4, np.int32), em[:n], el[:n], en[:n],
                np.zeros(n, bool))
    ell = convert.tables_from_numpy({"ell": (adj_idx,) + cols(nd)},
                                    device)["ell"]
    st = convert.tables_from_numpy({"drain": (adj,) + cols(ndd),
                                    "ell": (adj_idx_d,) + cols(ndd)}, device)
    rows = [[int(j) for j in row if j >= 0] for row in adj_idx]
    return ell, st["drain"], st["ell"], rows, deep_edges


def host_kahn_drain_rate(deps_lists):
    """bench.host_kahn_drain_rate: a queue-based Kahn drain over the gating
    edges on the host (every row Stable, every edge to an earlier id, so
    every edge gates); indegrees precomputed, the drain loop timed.
    Returns (txn/s, drained)."""
    from collections import deque
    n = len(deps_lists)
    rdeps = [[] for _ in range(n)]
    indeg = np.zeros(n, np.int64)
    for i, deps in enumerate(deps_lists):
        indeg[i] = len(deps)
        for j in deps:
            rdeps[j].append(i)
    t0 = time.perf_counter()
    q = deque(int(i) for i in np.nonzero(indeg == 0)[0])
    drained = 0
    while q:
        j = q.popleft()
        drained += 1
        for i in rdeps[j]:
            indeg[i] -= 1
            if indeg[i] == 0:
                q.append(i)
    return drained / (time.perf_counter() - t0), drained


def fixpoint_prefixes(torch, drk, state, ws):
    """{w: the applied set after w plain fixpoint sweeps} for the ELL
    ``state`` (w = 0 is the applied set it starts from)."""
    blocking, j = drk._ell_blocking(state)
    stable = state.status == drk.SLOT_STABLE
    applied = state.status == drk.SLOT_APPLIED
    out = {}
    for w in range(max(ws) + 1):
        if w in ws:
            out[w] = applied.clone()
        ready = stable & ~applied & ~(blocking & ~applied[j]).any(dim=1)
        applied = applied | ready
    return out


def burn_once(run_burn, device, n_ops):
    """run_burn with every store pinned to the device route; returns
    (result, per-run DeviceState counters)."""
    made = []
    orig = P.DeviceState.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        self.route_override = "device"
        made.append(self)

    P.DeviceState.__init__ = init
    try:
        r = run_burn(1, n_ops=n_ops, device=device)
    finally:
        P.DeviceState.__init__ = orig
    tot = {}
    for k in ("n_bucketed_queries", "n_dense_queries", "n_host_queries",
              "n_device_ticks", "n_host_ticks", "n_device_faults",
              "n_fallback_queries", "n_queries", "n_fused_flushes",
              "n_fused_ticks", "n_wavefront_ticks", "n_quarantines"):
        tot[k] = sum(getattr(d, k) for d in made)
    digest = hashlib.sha256(json.dumps(
        [r.ops_ok, r.ops_failed, r.ops_unresolved, r.epochs, r.restarts,
         r.evictions, r.stats, r.metrics_snapshot, r.span_export],
        sort_keys=True, default=str).encode()).hexdigest()
    return r, tot, digest


def back_to_back_ticks(torch, kern, drk, groups, on_cuda) -> dict:
    """Two fused dense ticks over disjoint members, the second launched
    before the first is harvested (a store's tick task runs later, and
    another batch may be prepared first): each member's harvest must read
    its own flags, its plain frontier's proposals, and on the card (where
    K6 dense writes into a pinned buffer) each tick must hold a pinned
    buffer of its own.  ``groups``: lists of (store, DeviceState) on one
    TickNode."""
    disp = groups[0][0][0].node.dispatcher
    fused = []
    for group in groups:
        devs = [d for _st, d in group]
        by = disp._prepare_fused_ticks(devs)
        check(len(by) == len(devs) and len({id(f) for f in by.values()}) == 1,
              f"two ticks: no single fused tick over {len(devs)} stores")
        fused.append((by[id(devs[0])], devs))
    slots = [getattr(f, "slot", None) for f, _d in fused]
    if on_cuda and k6_by_value(kern):
        check(None not in slots, "two ticks: a fused dense tick on the card "
              "has no pinned buffer of its own")
        check(slots[0].buf.data_ptr() != slots[1].buf.data_ptr(),
              "two ticks in flight share one pinned buffer")
    proposed = []
    for f, devs in fused:
        for d in devs:
            s_, live = d.drain.state()
            ready = drk.ready_frontier_plain(s_)[:len(live)].cpu().numpy()
            want = live[ready & d.drain.active[live]]
            got = f.result_for(d)
            check(np.array_equal(np.sort(got), np.sort(want)),
                  "two ticks: a member's harvest != its plain frontier")
            proposed.append(int(len(got)))
    return {"members": [len(d) for _f, d in fused], "proposed": proposed,
            "pinned_slots": [s is not None for s in slots]}


def device_ops(torch, fn, takes: int = 1) -> dict:
    """The device operations one call of ``fn`` makes (after a warm-up
    call), from a torch.profiler trace: kernels, copies and memsets, and
    their device time; the rest of a call's CUDA-event time is the host's
    (its path before the device starts, and the gaps between launches).
    The profiler may lose records of a short window, never add them: of
    ``takes`` traces that hold a device event the one with the most is
    kept (a trace with none is taken again, three times at most)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    events, kept, traces = [], 0, 0
    while kept < takes and traces < takes + 3:
        traces += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kept += bool(got)
        if len(got) > len(events):
            events = got
    ops = {"kernels": 0, "copies": 0, "memsets": 0, "device_us": 0.0,
           "names": [], "us": [], "traces": traces}
    for e in events:
        kind = ("copies" if e.name.startswith("Memcpy") else
                "memsets" if e.name.startswith("Memset") else "kernels")
        ops[kind] += 1
        ops["device_us"] += e.time_range.elapsed_us()
        ops["names"].append(e.name[:80])
        ops["us"].append(e.time_range.elapsed_us())
    return ops


def table_rows(ds, p=8, distinct=5, seed=8):
    """A P-row scatter into the store's device table as the burn's flushes
    make it (numpy rows from the host mirror, pad rows repeating the
    last): (columns, idx, rows)."""
    m = ds.deps
    live = np.nonzero(m.status >= 0)[0]
    rows = np.sort(np.random.default_rng(seed).choice(live, distinct,
                                                      replace=False))
    idx = np.concatenate([rows, np.full(p - distinct, rows[-1])]).astype(
        np.int32)
    return (list(m.device_table()), idx,
            [m.msb[idx], m.lsb[idx], m.node[idx], m.kind[idx],
             m.status[idx], m.lo[idx], m.hi[idx]])


def hold_device_memory(torch, dev) -> list:
    """Tensors that hold every block the caching allocator can still hand
    out on ``dev``: the cache emptied, then the largest allocation that
    succeeds, again and again, halving on each refusal down to the
    allocator's 512-byte granule.  While they live, any allocation on
    ``dev`` raises torch.OutOfMemoryError."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    held, size = [], torch.cuda.mem_get_info(dev)[0]
    while size >= 512:
        try:
            held.append(torch.empty(size, dtype=torch.uint8, device=dev))
        except torch.OutOfMemoryError:
            size //= 2
    return held


def real_error_check(torch, kern, dev, rehearsal) -> dict:
    """A real CUDA error the process survives, in a store's flush: device
    memory exhausted.  While one dirty-row scatter runs, every free byte
    of the card is held, so the scatter's allocation of its staging
    buffer raises torch.OutOfMemoryError.  The flush must fail over to
    the host route with the bytes a twin store gives with no error, and
    count one device fault and one quarantine; the quarantine's probe
    flush must restore the device route, still with the twin's bytes.
    Beside it, a return code that blames the library or its wrapper (a
    real scatter launch with no columns: cudaErrorInvalidValue) must
    propagate as a plain error, off the fault ladder."""
    from accord_tpu_torch.utils import faults
    if not rehearsal:
        before = kern.LAUNCHES["scatter_rows"]
        try:
            kern._launch("scatter_rows", dev, [None], [0, 1])
            fail("real error: a scatter of no columns launched")
        except faults.DEVICE_EXCEPTIONS as e:
            fail(f"real error: an invalid argument took the fault "
                 f"ladder: {e!r}")
        except RuntimeError as e:
            log(f"real error: an invalid argument propagates: {e}")
        check(kern.LAUNCHES["scatter_rows"] == before,
              "real error: a refused scatter was counted as a launch")
    n, b, keyspace = (4000, 256, 1_000_000) if not rehearsal else \
        (600, 32, 1_000_000)
    entries = build_workload(np.random.default_rng(31), n + 4 * b, keyspace,
                             8, P)
    batches = [make_queries(3100 + i, b, keyspace, 8, P) for i in range(12)]
    real = kern.scatter_rows
    fired = []

    def starved(cols, idx, rows):
        if fired:
            return real(cols, idx, rows)
        fired.append({"rows": len(idx), "oom": False})
        if rehearsal:   # no card: the allocator's exception, as it raises
            raise torch.OutOfMemoryError("CUDA out of memory (rehearsal)")
        held = hold_device_memory(torch, dev)
        fired[0]["held_bytes"] = sum(t.numel() for t in held)
        try:
            return real(cols, idx, rows)
        except torch.OutOfMemoryError:
            fired[0]["oom"] = True
            raise
        finally:
            del held
            torch.cuda.empty_cache()

    def run(provoke):
        store, ds, safe = build_store(entries[:n], keyspace, dev)
        ds.route_override = "device"
        out = []
        for i, batch in enumerate(batches):
            if i < 4:                     # new rows: a scatter each flush
                register(ds, store, entries[n + i * b:n + (i + 1) * b])
            if provoke and i == 1:
                kern.scatter_rows = starved
            try:
                out.append(deps_digest(attributed(ds, safe, batch)))
            finally:
                kern.scatter_rows = real
        return out, ds

    want, clean = run(False)
    got, ds = run(True)
    res = {k: getattr(ds, k) for k in (
        "n_device_faults", "n_quarantines", "n_restores",
        "n_fallback_queries", "n_bucketed_queries", "n_dense_queries")}
    res["starved_scatter"] = fired[0] if fired else None
    log("real error check: " + json.dumps(res))
    check(fired and (rehearsal or fired[0]["oom"]),
          f"real error: the starved scatter did not run out of memory "
          f"{fired}")
    check(got == want, "real error: the failed-over flushes differ from "
          "the twin store's")
    check(clean.n_device_faults == 0 and clean.n_quarantines == 0,
          "real error: the twin store faulted")
    check(res["n_device_faults"] == 1 and res["n_quarantines"] == 1
          and res["n_restores"] == 1,
          f"real error: expected one fault, one quarantine, one restore "
          f"{res}")
    return res


def profile_window(torch, label: str, fn) -> dict:
    """Trace ``fn``: the device's busy share of the wall time and the
    device time by kernel name (the full table goes to ``OUT``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    (OUT / f"profile_{label}.txt").write_text(
        prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=40))
    top = [(k, round(us / 1e3, 3), c) for us, k, c in rows[:8]]
    log("profile: %s wall %.3f ms, device busy %.3f ms (%.2f%%, idle "
        "%.2f%%); top device time %s" % (
            label, wall_us / 1e3, busy / 1e3, 100 * busy / wall_us,
            100 - 100 * busy / wall_us, json.dumps(top)))
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_pct": 100 - 100 * busy / wall_us, "top": top}


def hot_keys_phase(torch, drk, store, dev3, safe, queries, b3, ell, dense,
                   dense_ell, rows, deep_edges, device, rehearsal) -> dict:
    """Phase 8: bench config 3 (``bench_hot_keys``, bench.py:350-566) on the
    port: the floors-pruned scan through the live hot store, the routed
    100k ELL drain, the 4,096-deep chain's dense oracle and routed drains,
    every dense route, the watermark prefixes, the fixpoint hatch and a
    failover.  The reference's counts (the same on every platform) are
    checked at full size."""
    import os
    from accord_tpu_torch.utils import faults
    from accord_tpu_torch.utils.random_source import RandomSource
    full = not rehearsal
    on_cuda = device.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    # 1. the scan: an untimed learning pass, then the timed pass pipelined
    # two deep (prune_floors, attributed); the router picks the routes
    batches = [queries[i * b3:(i + 1) * b3] for i in range(4)]
    for batch in batches:
        dev3.deps_query_batch_attributed(safe, batch,
                                         [P.DepsBuilder() for _ in batch])
    counters = ("n_host_queries", "n_bucketed_queries", "n_dense_queries",
                "n_device_faults", "n_fallback_queries")

    def collect(handle, batch):
        builders = [P.DepsBuilder() for _ in batch]
        dev3.deps_query_batch_end_attributed(safe, handle, builders)
        return sum(b.build().key_deps.relation_count() for b in builders)

    def timed_scan():
        """(deps_found, txn/s, route counts) of one timed pass."""
        c0 = {k: getattr(dev3, k) for k in counters}
        t0 = time.perf_counter()
        n_deps, pending = 0, []
        for batch in batches:
            pending.append((dev3.deps_query_batch_begin(
                batch, prune_floors=True, attributed=True), batch))
            if len(pending) >= 2:
                n_deps += collect(*pending.pop(0))
        while pending:
            n_deps += collect(*pending.pop(0))
        sync()
        return (n_deps, 4 * b3 / (time.perf_counter() - t0),
                {k: getattr(dev3, k) - v for k, v in c0.items()})

    n_deps, scan_rate, routes = timed_scan()
    # the same pass with the device route pinned: the scan kernels at this
    # shape, and the count may not move
    dev3.route_override = "device"
    n_deps_dev, scan_rate_dev, routes_dev = timed_scan()
    dev3.route_override = None
    log(f"phase8: hot-128 scan, {4 * b3} queries: deps_found {n_deps}, "
        f"{scan_rate:.1f} txn/s, routes {json.dumps(routes)}; device route "
        f"pinned: deps_found {n_deps_dev}, {scan_rate_dev:.1f} txn/s, "
        f"routes {json.dumps(routes_dev)}")
    check(not full or n_deps == 231_203,
          f"phase8: deps_found {n_deps} != 231203")
    check(n_deps_dev == n_deps, f"phase8: the device route found "
                                f"{n_deps_dev} deps, the routed pass {n_deps}")
    check(routes_dev["n_host_queries"] == 0, f"phase8: {routes_dev}")
    for r_ in (routes, routes_dev):
        check(r_["n_device_faults"] == 0 and r_["n_fallback_queries"] == 0,
              f"phase8: scan faults {r_}")

    # 2. the 100k ELL drain: an unseen shape runs the log-depth pass, the
    # card's probe prices the timed call; the fixpoint oracle directly
    nd = ell.status.shape[0]
    a1, n1, r1, route1 = drk.drain_ell_auto(ell)
    check(route1 == "ell-logdepth", f"phase8: unseen shape took {route1}")
    cal = drk.drain_calibration(device)
    sync()
    t0 = time.perf_counter()
    a2, n2, r2, route2 = drk.drain_ell_auto(ell)
    drained = int(n2.sum())
    ell_rate = drained / (time.perf_counter() - t0)
    fa, fn_, fsw = drk.drain_ell_levels(ell)
    fsw = int(fsw)
    kahn_ell, _ = host_kahn_drain_rate(rows)
    check(drained == nd and int(n1.sum()) == nd and int(fn_.sum()) == nd,
          f"phase8: drained {drained} of {nd}")
    check(all(torch.equal(x, fa) for x in (a1, a2))
          and all(torch.equal(x, fn_) for x in (n1, n2)),
          "phase8: the 100k routed drains disagree with the fixpoint")
    check(not full or fsw == 634, f"phase8: 100k fixpoint sweeps {fsw}")
    log(f"phase8: {nd}-txn ELL drain: first call {route1} ({r1} rounds); "
        f"the card's prices choose {route2} ({r2}), {ell_rate:.1f} txn/s "
        f"against host Kahn {kahn_ell:.1f} txn/s; fixpoint {fsw} sweeps; "
        "calibration " + json.dumps(cal))

    # 3. the deep chain: the dense oracle, the routed ELL drain 1 + 3 times
    ndd = dense.status.shape[0]
    oa, on_, osw = drk.drain_levels(dense)
    osw = int(osw)
    check(osw == ndd + 1, f"phase8: dense oracle sweeps {osw}")

    def same(res, what):
        check(torch.equal(res[0], oa) and torch.equal(res[1], on_),
              f"phase8: {what} != the dense oracle")

    same(drk.drain_ell_auto(dense_ell), "routed ELL drain (first)")
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        res = drk.drain_ell_auto(dense_ell)
        deep_drained = int(res[1].sum())
    deep_rate = deep_drained * 3 / (time.perf_counter() - t0)
    same(res, "routed ELL drain")
    deep_route, deep_count = res[3], res[2]
    lres = drk.drain_ell_logdepth(dense_ell)
    same(lres, "ELL log-depth drain")
    rounds = int(lres[2])
    check(not full or rounds == 13, f"phase8: chain rounds {rounds}")
    kahn_deep, _ = host_kahn_drain_rate(deep_edges)
    # drain_auto's three dense routes, each made the cheapest in turn after
    # the unseen shape's first (dense -> ELL log-depth) call
    drk._ROUTE_STATS.pop(("dense", ndd), None)
    res = drk.drain_auto(dense)
    check(res[3] == "dense-to-ell-logdepth", f"phase8: unseen {res[3]}")
    same(res, "dense-to-ell-logdepth (unseen)")
    forced = {}
    for route, c in (("dense-fixpoint", (1, 1, 1e-15, 1, 1)),
                     ("dense-logsq", (1, 1, 1, 1e-15, 1)),
                     ("dense-to-ell-logdepth", (1e-15, 1e-15, 1, 1, 1e-15))):
        drk.set_drain_calibration(*c)
        res = drk.drain_auto(dense)
        check(res[3] == route, f"phase8: forced {route}, got {res[3]}")
        same(res, route)
        forced[route] = res[2]
    drk.set_drain_calibration(**cal)
    res = drk.drain_auto(dense)
    same(res, "drain_auto at the card's prices")
    dense_route = res[3]
    # the watermark prefixes: w plain fixpoint sweeps
    ws = (0, 1, 2, ndd)
    want = fixpoint_prefixes(torch, drk, dense_ell, ws)
    applied0 = dense.status == drk.SLOT_APPLIED
    for w in ws:
        for form, res in (
                ("ell", drk.drain_ell_watermark(dense_ell, w)),
                ("dense", drk.drain_dense_watermark(
                    dense, torch.tensor(w, device=device)))):
            check(torch.equal(res[0], want[w])
                  and torch.equal(res[1], want[w] & ~applied0),
                  f"phase8: {form} watermark {w} != {w} fixpoint sweeps")
    log(f"phase8: {ndd}-deep chain: dense oracle {osw} sweeps; routed ELL "
        f"drain {deep_route} ({deep_count}), {deep_rate:.1f} txn/s against "
        f"host Kahn {kahn_deep:.1f} txn/s; ELL log-depth {rounds} rounds; "
        f"forced dense routes equal the oracle {json.dumps(forced)}; "
        f"drain_auto at the card's prices: {dense_route}; watermarks "
        f"{list(ws)} exact")

    # 4. the escape hatch, and one injected launch fault
    prior = os.environ.get(drk.DRAIN_ENV)
    os.environ[drk.DRAIN_ENV] = "fixpoint"
    try:
        hatch = (drk.drain_ell_auto(dense_ell), drk.drain_auto(dense))
    finally:
        if prior is None:
            os.environ.pop(drk.DRAIN_ENV)
        else:
            os.environ[drk.DRAIN_ENV] = prior
    check(hatch[0][3] == "ell-fixpoint" and hatch[1][3] == "dense-fixpoint",
          f"phase8: the hatch gave {hatch[0][3]}, {hatch[1][3]}")
    same(hatch[0], "ell-fixpoint (hatch)")
    same(hatch[1], "dense-fixpoint (hatch)")
    drk._ROUTE_STATS.pop(("ell",) + tuple(dense_ell.adj_idx.shape), None)
    f0 = drk.drain_counters()["drain_logdepth_failovers"]
    with faults.device_fault("kernel_launch", 1.0, RandomSource(3)):
        res = drk.drain_ell_auto(dense_ell)
    check(res[3] == "ell-fixpoint-failover"
          and drk.drain_counters()["drain_logdepth_failovers"] == f0 + 1,
          f"phase8: failover {res[3]} {drk.drain_counters()}")
    same(res, "ell-fixpoint-failover")
    log("phase8: ACCORD_TPU_DRAIN=fixpoint pins ell-fixpoint / "
        "dense-fixpoint; an injected kernel_launch fault gives "
        "ell-fixpoint-failover with the oracle's bytes; counters "
        + json.dumps(drk.drain_counters()))
    return {"deps_found": n_deps, "scan_txn_per_s": scan_rate,
            "scan_routes": routes,
            "device_route_scan": {"deps_found": n_deps_dev,
                                  "txn_per_s": scan_rate_dev,
                                  "routes": routes_dev},
            "ell_100k": {"first_route": route1, "first_rounds": r1,
                         "route": route2, "count": r2,
                         "txn_per_s": ell_rate, "fixpoint_sweeps": fsw,
                         "drained": drained,
                         "host_kahn_txn_per_s": kahn_ell},
            "chain": {"depth": ndd, "dense_oracle_sweeps": osw,
                      "route": deep_route, "count": deep_count,
                      "txn_per_s": deep_rate, "logdepth_rounds": rounds,
                      "host_kahn_txn_per_s": kahn_deep,
                      "forced_dense_routes": forced,
                      "squarings": forced["dense-logsq"],
                      "drain_auto_route": dense_route},
            "calibration": cal, "counters": drk.drain_counters()}


# -- the mesh kernels (K11-K13) and the mesh phases ---------------------------

def calc_needed_ops(torch, dk, tables, query) -> int:
    """The operations K11's inputs need, counted with torch on their
    device: per (query, slot) the status test (1); per (query, live slot)
    the (slot interval, query interval) pairs up to the first that
    overlaps, slot columns outer (2 each: every pair when none does); per
    (query, live slot) with an overlap the predicate (witness 2, earlier
    3, not self 3, above the floor 3) and the max-conflict compare (3).
    The formula b n (2 m m_t + 12) counts every pair and every test."""
    b, m = query.lo.shape
    ops = 0
    for t in tables:
        n, m_t = t.lo.shape
        ops += b * n
        live = ((t.status >= dk.SLOT_TRANSITIVE)
                & (t.status != dk.SLOT_INVALIDATED))
        lo, hi = t.lo[live], t.hi[live]
        nl, w = lo.shape[0], m_t * m
        step = max(1, (1 << 26) // max(nl * w, 1))
        for r0 in range(0, b, step):
            qlo, qhi = query.lo[r0:r0 + step], query.hi[r0:r0 + step]
            ov = ((qlo[:, None, None, :] <= hi[None, :, :, None])
                  & (lo[None, :, :, None] <= qhi[:, None, None, :])
                  ).reshape(qlo.shape[0], nl, w)
            hit = ov.any(dim=2)
            first = torch.where(hit, ov.to(torch.int8).argmax(dim=2) + 1, w)
            ops += 2 * int(first.sum()) + 14 * int(hit.sum())
    return ops


def calc_case(torch, kern, dk, tables, query, prune=None):
    """K11: the dep mask and max-conflict candidates of the slices of one
    device: each table read once, the [B, N] mask written once.  Its
    operations are what this run's data needs (``calc_needed_ops``),
    counted only when the case is timed; the formula beside them."""
    b, m = query.lo.shape
    n = sum(t.capacity for t in tables)
    m_t = tables[0].lo.shape[1]
    nbytes = (n * (28 + 16 * m_t) + b * n + b * (7 + 2 * m) * 8
              + len(tables) * b * 20)

    def flat(out):
        return tuple(out[0]) + tuple(out[1])

    def ops():
        return (calc_needed_ops(torch, dk, tables, query),
                {"ops_formula": b * n * (2 * m * m_t + 12)})
    return (lambda: flat(kern.calc_deps(tables, query, prune)),
            lambda: flat(dk.calc_deps_plain(tables, query, prune)), None,
            nbytes, ops)


def calc_inputs(seed, dk, ns, b, m=1, m_t=4, dead=(), space=1 << 20):
    """K11's edge inputs, made in bulk: slices of ``ns`` slots (every slot
    of the slices in ``dead`` FREE or INVALIDATED), each slot's first
    interval set and the rest PAD at 40%, over ``space`` keys; ``b``
    queries of ``m`` intervals up to 4,096 keys wide, 40% of them bounded
    by a slot's id and each naming a slot's id as its own.  Returns the
    slices' columns and the qmat."""
    rng = np.random.default_rng(seed)
    tables = []
    for i, n in enumerate(ns):
        msb, lsb, node = _ids(rng, n)
        kind = rng.integers(0, 6, n).astype(np.int32)
        status = (rng.choice(np.array([dk.SLOT_FREE, dk.SLOT_INVALIDATED],
                                      np.int32), n) if i in dead
                  else rng.integers(-1, 7, n).astype(np.int32))
        lo = rng.integers(0, space, (n, m_t)).astype(np.int64)
        hi = lo + np.where(rng.random((n, m_t)) < 0.6, 0,
                           rng.integers(1, 64, (n, m_t)))
        pad = rng.random((n, m_t)) < 0.4
        pad[:, 0] = False
        lo[pad], hi[pad] = dk.PAD_LO, dk.PAD_HI
        tables.append((msb, lsb, node, kind, status, lo, hi))
    msb, lsb, node = (np.concatenate([t[c] for t in tables]) for c in range(3))
    qmat = np.zeros((b, 7 + 2 * m), np.int64)
    bm, bl, bn = _ids(rng, b)
    pick = rng.integers(0, max(len(msb), 1), b)
    same = (rng.random(b) < 0.4) & (len(msb) > 0)
    ids = [c[pick] if len(c) else np.zeros(b, c.dtype)
           for c in (msb, lsb, node)]
    qmat[:, 0] = np.where(same, ids[0], bm)
    qmat[:, 1] = np.where(same, ids[1], bl)
    qmat[:, 2] = np.where(same, ids[2], bn)
    qmat[:, 3] = rng.integers(0, 1 << 6, b)
    qmat[:, 4], qmat[:, 5], qmat[:, 6] = ids
    qlo = rng.integers(0, space, (b, m)).astype(np.int64)
    qmat[:, 7:7 + m] = qlo
    qmat[:, 7 + m:] = qlo + rng.integers(0, 1 << 12, (b, m))
    return tables, qmat


def calc_edge_cases(torch, kern, dk, convert, dev) -> dict:
    """K11 at the edges of its design: ragged slices in one call (131,072
    and 1,000 slots; 0 and 500), B = 1 and B = 129 (two query chunks), a
    slice whose every slot is dead, the prune floor, the interval widths
    the kernel unrolls (m_t 1, 2, 8) and one it loops over (3, with 3
    query intervals), and 17 slices (two launches)."""
    cases = {}
    prune = (2, 3, 1)
    for tag, ns, b, kw, pr in (
            ("ragged 131072+1000", (131_072, 1000), 128, {}, None),
            ("ragged 0+500", (0, 500), 16, {}, None),
            ("B1", (4096, 4096), 1, {}, None),
            ("B129", (4096, 2000, 4096), 129, {}, None),
            ("dead slice", (4096, 4096, 4096), 32, {"dead": (1,)}, None),
            ("prune", (4096, 4096), 64, {}, prune),
            ("m_t 1 m 2", (3000, 1000), 32, {"m_t": 1, "m": 2}, prune),
            ("m_t 2", (2048,), 32, {"m_t": 2}, None),
            ("m_t 3 m 3", (3000, 1000), 32, {"m_t": 3, "m": 3}, None),
            ("m_t 8", (2048, 64), 32, {"m_t": 8}, prune),
            ("17 slices", (300,) * 17, 24, {}, None)):
        cols, qmat = calc_inputs(len(cases) + 70, dk, ns, b, **kw)
        tabs = [convert.tables_from_numpy({"table": c}, dev)["table"]
                for c in cols]
        q = dk.query_from_qmat(torch.from_numpy(qmat).to(dev),
                               kw.get("m", 1))
        cases[f"calc_deps[{tag}]"] = calc_case(torch, kern, dk, tabs, q, pr)
    return cases


def ts_max_case(torch, kern, dk, msb, lsb, node):
    """K11's cross-shard reduce over [d, B] candidates."""
    c, r = msb.shape
    return (lambda: kern.ts_max(msb, lsb, node),
            lambda: dk.ts_max_plain(msb, lsb, node), None,
            c * r * 20 + r * 20, c * r * 4)


def _composites(torch, blocks, s, codespace):
    """The reference merge's flat sort input: every block's live (row,
    code) composites, int64 max elsewhere — what torch.sort would sort."""
    out = []
    for blk in blocks:
        for h, e, off in blk:
            row_end = h[5:].to(torch.int64)
            pos = torch.arange(s, device=e.device)
            row = torch.searchsorted(row_end, pos, right=True)
            code = e.to(torch.int64)
            code = torch.where(code >= 0, code + off, code)
            live = pos < h[0].to(torch.int64)
            out.append(torch.where(live, row * codespace + code,
                                   torch.full_like(code, 2 ** 63 - 1)))
    return torch.stack(out).reshape(len(blocks), -1)


def merge_case(torch, kern, psh, blocks, b, s, codespace, dedupe_key_m=0,
               dom=None, mq=None):
    """K12: each shard block's live entries read once, the merged block
    (d*s entries) written once; a d-way merge's comparisons."""
    d = len(blocks[0])
    cs = blocks[0][0][1].element_size()
    live = sum(min(max(int(h[0]), 0), s) for blk in blocks
               for h, _e, _o in blk)
    nbytes = (live * cs + len(blocks) * (d + 1) * (5 + b) * 4
              + len(blocks) * d * s * cs
              + (dom.numel() * 4 if dedupe_key_m else 0))
    ops = live * 4 * max(1, int(np.ceil(np.log2(d))))
    comp = _composites(torch, blocks, s, codespace)
    return (lambda: kern.merge_blocks(blocks, b, s, codespace, dedupe_key_m,
                                      dom, mq),
            lambda: psh.merge_blocks_plain(blocks, b, s, codespace,
                                           dedupe_key_m, dom, mq),
            lambda: torch.sort(comp, dim=1), nbytes, ops)


def sweep_args(torch, psh, mesh, state, drain):
    """K13's arguments for one sweep of ``state`` row-sharded over
    ``mesh`` (all slices on mesh device 0): (rows, cols, n_l, n)."""
    slices = psh._sharded_rows(mesh, state)
    n_l = slices[0].status.shape[0]
    applied = [s.status == 5 for s in slices] if drain else None
    cols = [(s.status, s.exec_msb, s.exec_lsb, s.exec_node,
             applied[j] if drain else None) for j, s in enumerate(slices)]
    rows = [(*slices[i], applied[i] if drain else None,
             torch.empty(n_l, dtype=torch.bool, device=mesh.dev0), i)
            for i in range(mesh.size)]
    return rows, cols, n_l, n_l * mesh.size


def sweep_case(torch, kern, drk, psh, rows, cols, n_l, n):
    """K13: one frontier sweep (applied slot None) or one fixpoint sweep;
    the bound is the frontier's work on the gathered state; the library
    call is torch.any of the precomputed blocking against the unapplied
    columns."""
    drain = rows[0][6] is not None
    # a swept row reads its status and executeAt from its slice's column
    # arrays: hand the kernel the same tensors (a recorded call's copies
    # are distinct)
    rows = [(r[0], *cols[r[8]][:4], r[5], cols[r[8]][4] if drain else None,
             r[7], r[8]) for r in rows]
    full = drk.DrainState(
        torch.cat([r[0] for r in rows]), torch.cat([c[0] for c in cols]),
        torch.cat([c[1] for c in cols]), torch.cat([c[2] for c in cols]),
        torch.cat([c[3] for c in cols]), torch.cat([r[5] for r in rows]))
    blk = drk.blocking_matrix(full)
    unapplied = ~(torch.cat([c[4] for c in cols]) if drain
                  else full.status == 5)

    def own(rs):
        return [r[:7] + (torch.empty_like(r[7]),) + r[8:] for r in rs]

    rk, rp = own(rows), own(rows)
    name = "sharded_drain" if drain else "sharded_frontier"

    def run_kernel():
        flag = getattr(kern, name)(rk, cols, n_l, n)
        return tuple(r[7] for r in rk) + ((flag,) if drain else ())

    def run_plain():
        flag = psh.sweep_plain(rp, cols, n_l, drain)
        return tuple(r[7] for r in rp) + ((flag,) if drain else ())

    return (run_kernel, run_plain,
            lambda: torch.any(blk & unapplied[None, :], dim=1),
            *frontier_work(torch, drk, full))


def fixd_case(torch, kern, drk, psh, rows, cols, n_l, n):
    """K13's one-launch fixpoint drain (every slice on one card): each
    slice's final applied flags and the sweep count against the plain
    sweep loop; the bound is a drain's work on the gathered state (K8's:
    one pass over the Stable rows' adjacency)."""
    rows = [(r[0], *cols[r[8]][:4], r[5], None, r[7], r[8]) for r in rows]
    cols = [c[:4] + (None,) for c in cols]
    full = drk.DrainState(
        torch.cat([r[0] for r in rows]), torch.cat([c[0] for c in cols]),
        torch.cat([c[1] for c in cols]), torch.cat([c[2] for c in cols]),
        torch.cat([c[3] for c in cols]), torch.cat([r[5] for r in rows]))

    def own():
        return [r[:7] + (torch.empty_like(r[7]),) + r[8:] for r in rows]

    rk, rp = own(), own()

    def run_kernel():
        sweeps = kern.sharded_drain_fix(rk, cols, n_l, n)
        return tuple(r[7] for r in rk) + (sweeps,)

    def run_plain():
        sweeps = psh.drain_fix_plain(rp, cols, n_l)
        return tuple(r[7] for r in rp) + (sweeps,)

    return (run_kernel, run_plain, None,
            *level_work(torch, drk, full, n + 4))


def overflow_blocks(torch, dev, kern, dk, psh, convert, mesh, seed=1, s=16,
                    k=2):
    """A real K12 overflow: each slice's deps scan (K1b) and attribution
    (K2) at a budget too small for its answers, which leaves -1 holes
    inside the attributed rows.  Returns merge_case's (blocks, B, s,
    codespace); fails unless a block overflowed with its composites
    descending somewhere."""
    inp = small_inputs(seed, dk)
    up = convert.tables_from_numpy({"table": inp["table"],
                                    "attr": inp["attr"],
                                    "aidx": inp["aidx"]}, dev)
    qmat = torch.from_numpy(inp["qmat"]).to(dev)
    rankb = torch.from_numpy(inp["rankb"]).to(dev)
    m, m_t = inp["m"], inp["m_t"]
    sh = psh.shard_table(mesh, up["table"])
    attr = dk.AttrCols(*(psh._split_rows(mesh, c) for c in up["attr"]))
    shard_n = sh.lo[0].shape[0]
    blocks = []
    for i in range(mesh.size):
        t = psh.slice_of(sh, i)
        hdr_raw, ent = kern.deps_dense(t, qmat, m, s, k, inp["prune"], False)
        hdr, ent = kern.attr_post(t.lo, psh.slice_of(attr, i), up["aidx"],
                                  rankb, hdr_raw, ent, m_t, m, True, True)
        blocks.append((hdr, ent, i * shard_n * m_t * m))
    codespace = mesh.size * shard_n * m_t * m
    comp = _composites(torch, [blocks], s, codespace).reshape(mesh.size, s)
    check(any(int(h[1]) > s or int(h[2]) > k for h, _e, _o in blocks)
          and bool((comp.diff(dim=1) < 0).any()),
          "K12 overflow case: no overflowed block with a descent")
    return [blocks], qmat.shape[0], s, codespace


def tok_case(torch, kern, psh, ents, los, sn, m_t, m):
    """The K2 extension's token gather: the codes read once, one lo word
    gathered per live entry, the [d, s] tokens written once."""
    d, s = len(ents), ents[0].shape[0]
    live = sum(int((e >= 0).sum()) for e in ents)
    return (lambda: kern.attr_tok(ents, los, sn, m_t, m),
            lambda: psh.attr_tok_plain(ents, los, sn, m_t, m), None,
            d * s * (ents[0].element_size() + 8) + live * 8, d * s * 8)


def tok_edge_inputs(torch, dev, d, wide, none, seed, sn=64, m_t=4, m=4,
                    s=300):
    """A K2 token input of ``d`` shards on ``dev``: every slice's lo a
    random int64[sn, m_t] (every third slice None when ``none``: on
    another device), ``s`` codes a shard, int64 when ``wide``, with -1
    holes, negative codes (Python's floor division and modulo differ from
    C's there) and codes past the last slice."""
    rng = np.random.default_rng(seed)
    mq = m_t * m
    los = [torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, (sn, m_t)))
           .to(dev) for _ in range(d)]
    if none:
        los = [lo if o % 3 else None for o, lo in enumerate(los)]
    codes = rng.integers(-3 * mq, (d * sn + 2) * mq, (d, s))
    codes[:, :3] = [-1, -mq - 1, d * sn * mq + 5]
    ents = [torch.from_numpy(c.astype(np.int64 if wide else np.int32))
            .to(dev) for c in codes]
    return ents, los, sn, m_t, m


# K2 token inputs past what a launch takes by value (40 shards: a launch
# takes every slice's lo and 24 rows), with None slices, int32 and int64
TOK_EDGES = {"d40 i32": (40, False, False), "d40 i64 None": (40, True, True),
             "d8 i64": (8, True, False), "d8 i32 None": (8, False, True)}


def merge_blocks_small(seed, torch, dev, d=8, b=6, s=24, codespace=4096,
                       dup=False, wide=False, n_s=1, holes=False):
    """d ascending shard blocks (some rows empty, repeats across shards in
    the bucketed form) for each of ``n_s`` stores, as a K12 argument list;
    ``holes``: every block overflowed, with -1 holes inside its rows."""
    rng = np.random.default_rng(seed)
    hr = np.random.default_rng(seed + 1000)
    pool = rng.integers(0, codespace, 12)
    stores = []
    for _st in range(n_s):
        blk = []
        for i in range(d):
            counts = rng.integers(0, 5, b)
            while counts.sum() > s:
                counts[np.argmax(counts)] -= 1
            ent = np.full(s, -1, np.int64 if wide else np.int32)
            pos = 0
            for r in range(b):
                src = pool if dup else np.arange(codespace)
                codes = np.sort(rng.choice(src, min(counts[r], len(src)),
                                           replace=False))
                ent[pos:pos + len(codes)] = codes
                pos += len(codes)
                counts[r] = len(codes)
            row_end = np.cumsum(counts)
            hdr = np.concatenate([[row_end[-1], row_end[-1], counts.max(),
                                   rng.integers(0, 4), rng.integers(0, 4)],
                                  row_end]).astype(np.int32)
            if holes and pos:
                ent[hr.choice(pos, min(pos, 3), replace=False)] = -1
                hdr[1] = s + 1 + hr.integers(0, 5)
            off = 0 if dup else i * codespace
            blk.append((torch.from_numpy(hdr).to(dev),
                        torch.from_numpy(ent).to(dev), off))
        stores.append(blk)
    return stores


def mesh_small_cases(torch, dev, kern, dk, drk, psh, convert, mesh):
    """K11-K13, the token gather and the K1a / K2 extensions at small
    shapes over an 8-slice mesh on ``dev``."""
    cases = {}
    for seed, pruned in ((1, False), (2, True)):
        inp = small_inputs(seed, dk)
        up = convert.tables_from_numpy(
            {"table": inp["table"], "buckets": inp["buckets"],
             "attr": inp["attr"], "aidx": inp["aidx"]}, dev)
        q = dk.query_from_qmat(torch.from_numpy(inp["qmat"]).to(dev),
                               inp["m"])
        sh = psh.shard_table(mesh, up["table"])
        tabs = [psh.slice_of(sh, i) for i in range(mesh.size)]
        prune = inp["prune"] if pruned else None
        cases[f"calc_deps[seed{seed}]"] = calc_case(torch, kern, dk, tabs, q,
                                                    prune)
        _m, (cm, cl, cn) = dk.calc_deps_plain(tabs, q, prune)
        cases[f"ts_max[seed{seed}]"] = ts_max_case(torch, kern, dk, cm, cl,
                                                   cn)
        # the K1a row-sharded slice and the K2 token input
        m, m_t = inp["m"], inp["m_t"]
        qb = torch.from_numpy(inp["qmat_b"]).to(dev)
        bsh = psh.shard_bucket_table(mesh, up["buckets"])
        for i in (0, 3):
            bt = psh.slice_of(bsh, i)
            roff = i * bt.blo.shape[0]
            cases[f"deps_bucketed[seed{seed} row_offset {roff}]"] = (
                lambda bt=bt, roff=roff: kern.deps_bucketed(
                    m_t, bt, qb, m, 4, 2048, 64, inp["prune"], None, False,
                    roff),
                lambda bt=bt, roff=roff: dk.bucketed_flat_plain(
                    m_t, bt, qb, m, 4, 2048, 64, inp["prune"], None, False,
                    roff), None, 0, 0)
        raw = [dk.bucketed_flat_plain(m_t, psh.slice_of(bsh, i), qb, m, 4,
                                      2048, 64, inp["prune"], None, False,
                                      i * bsh.blo[0].shape[0])
               for i in range(mesh.size)]
        ents = [e for _h, e in raw]
        sn = sh.lo[0].shape[0]
        cases[f"attr_tok[seed{seed}]"] = tok_case(
            torch, kern, psh, ents, list(sh.lo), sn, m_t, m)
        tok = psh.attr_tok_plain(ents, list(sh.lo), sn, m_t, m)
        rankb = torch.from_numpy(inp["rankb"]).to(dev)
        cases[f"attr_post[tok seed{seed}]"] = (
            lambda: kern.attr_post(None, up["attr"], up["aidx"], rankb,
                                   raw[1][0], raw[1][1], m_t, m, True, True,
                                   tok=tok[1].contiguous()),
            lambda: dk.attr_post_plain(None, up["attr"], up["aidx"], rankb,
                                       raw[1][0], raw[1][1], m_t, m, True,
                                       True, tok=tok[1]), None, 0, 0)
    for seed, dup, wide in ((3, False, False), (4, True, False),
                            (5, False, True), (6, True, True)):
        blocks = merge_blocks_small(seed, torch, dev, dup=dup, wide=wide)
        n_dom = 4096 // 8
        dom = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 2, n_dom).astype(np.int32)).to(dev)
        tag = f"[seed{seed}{' dedupe' if dup else ''}{' i64' if wide else ''}]"
        cs = 4096 if dup else 8 * 4096
        cases["merge_blocks" + tag] = merge_case(
            torch, kern, psh, blocks, 6, 24, cs, 4 if dup else 0,
            dom if dup else None, 8)
    # S stores in one launch: under (3 x 8 blocks) and over (17 x 8 = 136)
    # the blocks a launch takes by value, the dedupe on and off, blocks
    # that overflowed (-1 holes inside their rows) or not; one block (no
    # merge level) and three (an odd run merged with none)
    n_dom = 4096 // 8
    for n_s, d, dup, holes in ((3, 8, False, False), (3, 8, True, True),
                               (17, 8, False, True), (17, 8, True, False),
                               (2, 1, True, True), (2, 3, False, True)):
        blocks = merge_blocks_small(50 + n_s + d, torch, dev, d=d, dup=dup,
                                    n_s=n_s, holes=holes)
        dom = torch.from_numpy(np.random.default_rng(n_s).integers(
            0, 2, n_dom).astype(np.int32)).to(dev)
        tag = (f"[S{n_s} d{d}{' dedupe' if dup else ''}"
               f"{' holes' if holes else ''}]")
        cases["merge_blocks" + tag] = merge_case(
            torch, kern, psh, blocks, 6, 24, 4096 if dup else d * 4096,
            4 if dup else 0, dom if dup else None, 8)
    for seed, s, k in ((1, 16, 2), (2, 24, 2)):
        cases[f"merge_blocks[overflow seed{seed} s{s}]"] = merge_case(
            torch, kern, psh, *overflow_blocks(torch, dev, kern, dk, psh,
                                               convert, mesh, seed, s, k))
    for seed, n in ((3, 64), (4, 512)):
        dense, _ell = small_drain(seed, n)
        st = convert.tables_from_numpy({"drain": dense}, dev)["drain"]
        for drain in (False, True):
            args = sweep_args(torch, psh, mesh, st, drain)
            name = "sharded_drain" if drain else "sharded_frontier"
            cases[f"{name}[n{n}]"] = sweep_case(torch, kern, drk, psh, *args)
        cases[f"sharded_drain_fix[n{n}]"] = fixd_case(
            torch, kern, drk, psh, *sweep_args(torch, psh, mesh, st, False))
    # K13 on K8's handover graphs and a wide input (every level on the
    # grid), sliced 8 ways
    graphs = {k: g for k, g in k8_graphs(dev).items()
              if k.startswith("handover")}
    graphs["wide"] = wide_drain_input(
        convert, dev, 4096 if dev.type == "cuda" else 512)
    for tag, g in graphs.items():
        st = (g if isinstance(g, drk.DrainState) else
              convert.tables_from_numpy({"drain": g}, dev)["drain"])
        cases[f"sharded_drain_fix[{tag}]"] = fixd_case(
            torch, kern, drk, psh, *sweep_args(torch, psh, mesh, st, False))
    return cases


def mesh_fused_check(torch, dk, psh, convert, dev, mesh) -> dict:
    """The mesh's fused forms on ``dev``: ``sharded_fused_flat`` and
    ``sharded_fused_attr`` (a K5 launch of each stage a slice, over the
    slices' tuples, which carry no plan) on a seeded group of three stores
    over the 8-slice mesh, each byte-equal to the same function on CPU
    copies of its inputs over an 8-slice CPU mesh."""
    d = mesh.size
    shapes = ((d * 64, 4), (d * 32, 2), (d * 128, 4))
    outs = []
    for dv, ms in ((dev, mesh), (torch.device("cpu"),
                                 psh.make_mesh(d, "cpu"))):
        g = fused_group(torch, convert, dv, dk, 90, shapes, 8)
        tabs = [psh.shard_table(ms, t) for t in g["tables"]]
        attrs = [type(a)(*(psh._split_rows(ms, c) for c in a))
                 for a in g["attrs"]]
        pr = tuple(torch.from_numpy(p) for p in g["prunes"])
        flat = psh.sharded_fused_flat(ms, len(shapes), g["m"], 512, 64)(
            *tabs, g["qmats"], *pr)
        attr = psh.sharded_fused_attr(ms, len(shapes), g["m"], 512, 64)(
            *tabs, *attrs, *g["aidxs"], g["qmats"], g["rankbs"], *pr)
        outs.append([t.cpu() for t in (*flat, *attr)])
    err = _max_abs_err(torch, tuple(outs[0]), tuple(outs[1]))
    check(err == 0, "phase9: the mesh's fused forms on the card != on CPU "
                    f"copies: {_diff_report(torch, outs[0], outs[1])}")
    out = {"stores": [list(x) for x in shapes], "slices": d,
           "flat": [list(t.shape) for t in outs[0][:2]],
           "attr": [list(t.shape) for t in outs[0][2:]],
           "entries": int(outs[0][2][:, 0].sum()), "max_abs_err": err}
    log("phase9: the mesh's fused forms equal on CPU copies " + json.dumps(out))
    return out


def config4_phase(torch, dev, mesh, rehearsal):
    """Phase 9: bench config 4 (``config4_child``, bench.py:859-932) on
    the 8-slice mesh: 20,000 txns over 64 shards of 4,096 keys, 512
    attributed queries through the mesh-bucketed, mesh-dense, host and
    routed paths; every route builds the same Deps."""
    SHARDS, WIDTH = 64, 4096
    N4, B4 = (20_000, 512) if not rehearsal else (20_000, 64)
    rng = np.random.default_rng(11)
    store = Store()
    ds = P.DeviceState(store, device=dev, mesh=mesh)
    safe = Safe(store)
    hlcs = rng.choice(np.arange(1, 2_000_000), size=N4, replace=False)
    t0 = time.perf_counter()
    for i in range(N4):
        base = int(rng.integers(0, SHARDS)) * WIDTH
        tid = P.TxnId.create(1, int(hlcs[i]), P.TxnKind.Write, P.Domain.Key,
                             1 + i % 5)
        toks = [base + int(t) for t in rng.integers(0, WIDTH,
                                                    rng.integers(1, 3))]
        ds.register(tid, int(P.InternalStatus.PREACCEPTED),
                    P.Keys([P.IntKey(t) for t in toks]))
    replay_rate = N4 / (time.perf_counter() - t0)
    queries = []
    for _b in range(B4):
        bound = P.TxnId.create(1, int(rng.integers(2_000_000, 3_000_000)),
                               P.TxnKind.Write, P.Domain.Key, 1)
        base = int(rng.integers(0, SHARDS)) * WIDTH
        toks = [base + int(t) for t in rng.integers(0, WIDTH, 2)]
        queries.append((bound, bound, bound.kind().witnesses(), toks, []))

    def timed(route, reps=4):
        """(txn/s over ``reps`` passes after a warm-up, the warm-up's
        Deps)."""
        ds.route_override = route
        first = deps_digest(attributed(ds, safe, queries))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _i in range(reps):
            attributed(ds, safe, queries)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return B4 * reps / (time.perf_counter() - t1), first

    rates, digests = {}, {}
    rates["mesh_bucketed"], digests["mesh_bucketed"] = timed("device")
    check(ds.n_mesh_bucketed_queries > 0,
          "phase9: the mesh bucketed kernels never ran")
    rates["mesh_dense"], digests["mesh_dense"] = timed("dense")
    rates["host"], digests["host"] = timed("host")
    routes = []
    ds.on_route = lambda route, nq: routes.append(route)
    rates["routed"], digests["routed"] = timed(None)
    ds.on_route = None
    found = sum(len(t) for k, r in digests["host"] for _k, t in k)
    check(found > 0, "phase9: empty Deps")
    for name in ("mesh_bucketed", "mesh_dense", "routed"):
        check(digests[name] == digests["host"],
              f"phase9: the {name} route built other Deps than the host's")
    out = {"txn_per_s": rates, "routed": sorted(set(routes)),
           "register_txn_per_s": replay_rate, "deps_found": found,
           "counters": {k: getattr(ds, k) for k in (
               "n_mesh_queries", "n_mesh_bucketed_queries",
               "n_host_queries", "n_device_faults")}}
    log("phase9: config 4, " + json.dumps(out))
    return out


def _csr_equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_csr_equal(x, y)
                                        for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def config5b_phase(torch, dk, psh, dev, mesh, rehearsal):
    """Phase 10: bench config 5b (``bench_store_sharded``, bench.py:
    743-858): one store walked up the budget ladder to 2^20 slots against
    a 2^17-slot budget spills to 8 slices; 128 pruned queries on the pinned
    dense route give the host oracle's CSR byte for byte.  Then K11 over
    the sliced table at full width against its plain version, and a fault
    in slice 3: the hybrid flush gives the same Deps."""
    from accord_tpu_torch.ops.packing import unpack_txn_id
    N, BUDGET, B5, KEYS5 = ((1 << 20, 1 << 17, 128, 1 << 22)
                            if not rehearsal else
                            (1 << 14, 1 << 11, 32, 1 << 16))
    store = Store()
    ds = P.DeviceState(store, device=dev, mesh=mesh)
    safe = Safe(store)
    ds.device_budget_slots = BUDGET
    ds.route_override = "dense"
    m = ds.deps
    t0 = time.perf_counter()
    while m.capacity < N:
        m.free_slots.clear()      # force the grow (no compacted slack)
        m._grow_capacity()
    grow_s = time.perf_counter() - t0
    sh = ds.store_shards
    check(sh is not None and sh.active and sh.d == 8,
          "phase10: the ladder never spilled to 8 slices")
    check(not ds.host_pinned, "phase10: the store was pinned to the host")
    rng = np.random.default_rng(13)
    hlc = rng.choice(np.arange(1, 4 * N, dtype=np.int64), size=N,
                     replace=False)
    flags = np.int64((int(P.TxnKind.Write) << 1) | int(P.Domain.Key))
    m.msb[:] = np.int64(1) << 16
    m.lsb[:] = (hlc << 16) | flags
    m.node[:] = (np.arange(N) % 5 + 1).astype(np.int32)
    m.kind[:] = int(P.TxnKind.Write)
    m.domain[:] = int(P.Domain.Key)
    m.status[:] = dk.SLOT_TRANSITIVE
    toks = rng.integers(0, KEYS5, size=N).astype(np.int64)
    m.lo[:, 0] = toks
    m.hi[:, 0] = toks
    m.free_slots = []
    m.n_live = N
    m.version += 1
    m.mut_version += 1
    m._snap = None
    m._device = None
    m._device_sh = None
    m._dirty.clear()
    m._dirty_sh.clear()
    m._attr_dirty_sh.clear()
    queries = []
    for _ in range(B5):
        bound = P.TxnId.create(1, int(rng.integers(5 * N, 6 * N)),
                               P.TxnKind.Write, P.Domain.Key, 1)
        queries.append((bound, bound, bound.kind().witnesses(),
                        [int(rng.integers(0, KEYS5))], []))

    def run_csr():
        h = ds.deps_query_batch_begin(queries, immediate=True,
                                      prune_floors=True)
        return ds.deps_query_batch_end(h)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    ds.route_override = "host"
    t0 = time.perf_counter()
    host_csr = run_csr()
    host_s = time.perf_counter() - t0
    ds.route_override = "dense"
    t0 = time.perf_counter()
    shard_csr = run_csr()                     # the slices' first upload
    first_s = time.perf_counter() - t0
    check(_csr_equal(host_csr[:3], shard_csr[:3]),
          "phase10: the sharded CSR != the host oracle's")
    check(len(shard_csr[1]) > 0, "phase10: no deps found")
    check(ds.n_store_sharded_flushes >= 1,
          "phase10: the flush did not route sharded")
    reps = 2
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        again = run_csr()
    sync()
    dt = time.perf_counter() - t0
    check(_csr_equal(again[:3], host_csr[:3]), "phase10: a re-run differs")
    # K11 at full width over the resident slices: bool[128, 2^20]
    q_m = 1
    packed = [(sb, wit, tk, rg, tid) for (tid, sb, wit, tk, rg) in queries]
    query = dk.query_from_qmat(torch.from_numpy(
        dk.pack_query_matrix(packed, q_m)).to(dev), q_m)
    table = ds.deps.device_table_sharded(mesh)
    fn = psh.sharded_calculate_deps(mesh)
    fn(table, query)
    sync()
    t0 = time.perf_counter()
    masks, mc = fn(table, query)
    sync()
    k11_s = time.perf_counter() - t0
    tabs = [psh.slice_of(table, i) for i in range(mesh.size)]
    pm_, (cm, cl, cn) = dk.calc_deps_plain(tabs, query)
    want_mc = dk.ts_max_plain(cm, cl, cn)
    check(all(bool(torch.equal(a, b)) for a, b in zip(masks, pm_))
          and all(bool(torch.equal(a, b)) for a, b in zip(mc, want_mc)),
          "phase10: sharded calculate_deps != its plain version")
    mask_deps = int(sum(int(x.sum()) for x in masks))
    table_bytes = sum(t.numel() * t.element_size() for c in table for t in c)
    # a fault in slice 3: the attributed flushes go hybrid (slices 0-2,
    # 4-7 on the card, slice 3's slots from the host twin) with the same
    # Deps; the raw CSR path serves from the host meanwhile.  The slots
    # become PreAccepted first (the attribution elides TRANSITIVE key
    # deps, so the bench's fill would attribute to empty Deps), which the
    # slices take as a full re-upload
    m.obj[:] = [unpack_txn_id(a, b, c) for a, b, c in
                zip(m.msb.tolist(), m.lsb.tolist(), m.node.tolist())]
    m.status[:] = dk.SLOT_PREACCEPTED
    m.version += 1
    m.mut_version += 1
    m.attr_version += 1
    m._snap = None
    sh._shape = sh._attr_cap = None
    ds.route_override = "host"
    want = deps_digest(attributed(ds, safe, queries))
    ds.route_override = "dense"
    clean = deps_digest(attributed(ds, safe, queries))
    check(clean == want, "phase10: sharded attributed Deps != host")
    sh.last_slice_touched = 3
    ds._device_fault("transfer", "injected: slice 3 upload", sliced=True)
    check(sh.quarantined_slices() == [3],
          f"phase10: quarantined {sh.quarantined_slices()}")
    hs0 = ds.kernel_times.get("dispatch_host_slice", (0, 0.0))[0]
    hybrid = deps_digest(attributed(ds, safe, queries))
    check(ds.kernel_times.get("dispatch_host_slice", (0, 0.0))[0] == hs0 + 1,
          "phase10: the faulted flush was not hybrid")
    check(hybrid == want, "phase10: the hybrid flush's Deps != host")
    check(_csr_equal(run_csr()[:3], host_csr[:3]),
          "phase10: the raw CSR under the fault != host")
    found = sum(len(t) for k, r in want for _k, t in k)
    check(found > 0, "phase10: the attributed Deps are empty")
    out = {"slots": N, "budget": BUDGET, "slices": sh.d,
           "txn_per_s": B5 * reps / dt, "host_oracle_txn_per_s": B5 / host_s,
           "first_flush_s": first_s, "ladder_grow_s": grow_s,
           "k11_full_width_ms": k11_s * 1e3, "k11_mask_deps": mask_deps,
           "table_bytes": table_bytes, "mask_bytes": B5 * N,
           "deps_found": found,
           "counters": {k: getattr(ds, k) for k in (
               "n_store_sharded_flushes", "n_slice_quarantines",
               "n_shard_merge_bytes", "n_mesh_queries", "n_oom_degraded")}}
    log("phase10: config 5b, " + json.dumps(out))
    return out


def graft_phase(torch, kern, drk, psh, dev, mesh, dense3, ndd, rehearsal):
    """Phase 11: the graft entries on the card, the row-sharded frontier
    and fixpoint drain on config 3's 4,096-deep chain against K4b / K8,
    and a store with the mesh on ticking until a mesh tick served."""
    from accord_tpu_torch import graft_entry
    out = {}
    t0 = time.perf_counter()
    fn, args = graft_entry.entry(dev)
    got = fn(*args)
    fnc, argsc = graft_entry.entry("cpu")
    graft_entry._eq(got, fnc(*argsc), "entry() on the card vs its plain run")
    out["entry_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(8, dev)
    out["dryrun_multichip_s"] = time.perf_counter() - t0
    fr = psh.sharded_ready_frontier(mesh)(dense3)
    check(bool(torch.equal(fr, kern.frontier_dense(dense3))),
          "phase11: sharded_ready_frontier != frontier_dense")
    want = drk.drain(dense3)
    sd = psh.sharded_drain(mesh)
    before = {k: kern.LAUNCHES[k] for k in ("sharded_drain_fix",
                                            "sharded_drain")}
    sd(dense3)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    applied, newly = sd(dense3)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["sharded_drain_ms"] = (time.perf_counter() - t0) * 1e3
    check(bool(torch.equal(applied, want[0]))
          and bool(torch.equal(newly, want[1])),
          "phase11: sharded_drain != drain (K8)")
    out["sharded_drain_applied"] = int(applied.sum())
    # every slice on this card: one launch a drain, no per-sweep launches
    out["chain_drain_launches"] = {k: kern.LAUNCHES[k] - v
                                   for k, v in before.items()}
    check(rehearsal or out["chain_drain_launches"]
          == {"sharded_drain_fix": 2, "sharded_drain": 0},
          f"phase11: two chain drains took "
          f"{out['chain_drain_launches']} launches")
    # the mesh tick: config 3's chain alone in a store with the mesh on
    mstore, mds, _ids = chain_store(ndd, dev, mesh=mesh)
    st, _live = mds.drain.state()
    n = st.status.shape[0]
    out["mesh_tick_priced"] = bool(mds._mesh_tick_pays(n))
    if not out["mesh_tick_priced"]:
        # the pricing (this card's probes) keeps the tick single-device at
        # this size; pin it to hold the mesh tick's path
        mds._mesh_tick_pays = lambda _n: True
    ready = drk.ready_frontier_plain(st)[:len(_live)].cpu().numpy()
    want_p = {mds.drain.id_of[int(x)]
              for x in _live[ready & mds.drain.active[_live]]}
    mstore.run_ticks()
    check(mstore.ticks[:1] == [("mesh", len(want_p))]
          and mstore.proposed == want_p,
          f"phase11: the mesh tick proposed {mstore.ticks}")
    out["mesh_tick"] = mstore.ticks[:1]
    log("phase11: " + json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the control flow on the CPU at a tiny size "
                         "(plain versions only; never prints a result)")
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    import torch
    if not rehearsal and not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA "
             "card")
    try:
        import accord_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the accord_tpu_torch package is not importable here: {e}")
    from accord_tpu_torch.ops import _build
    from accord_tpu_torch.ops import convert
    from accord_tpu_torch.ops import deps_kernel as dk
    from accord_tpu_torch.ops import drain_kernel as drk
    from accord_tpu_torch.ops import kernels as kern
    from accord_tpu_torch.parallel import sharded as psh
    from accord_tpu_torch.sim.burn import run_burn
    P.load()
    global OUT, LOGIC_OPS
    if rehearsal:
        OUT = OUT.with_name("chip_smoke_rehearsal")
    OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cpu" if rehearsal else "cuda")
    on_cuda = dev.type == "cuda"
    t_start = time.perf_counter()

    # 1. environment
    env = environment(torch, rehearsal)

    # 2. build
    if on_cuda:
        _build.library()
        blog = _build.build_log()
        (OUT / "build_log.txt").write_text(blog["stderr"])
        log(f"build: {blog['seconds']:.2f} s (cached={blog['cached']}) "
            f"-> {_build.BUILD_DIR / _build.LIB_NAME}")
        LOGIC_OPS = logic_rate(torch, dev)
        env["logic_ops_per_s"] = LOGIC_OPS
        log(f"logic rate (SMs x 64 INT32 lanes x max SM clock): "
            f"{LOGIC_OPS / 1e12:.4f} T/s on {env['nvidia_smi']}: the peak "
            f"of every scalar bound below")
    log("K9 logsq_dense: mma.sync.m16n8k256 b1 AND-popc -> s32, output "
        "tile 128 x 128, k-chunk 256 bits, 8 warps of 32 x 64")

    # 3a. small-size kernel checks; the mesh kernels over 8 slices of one
    # card (phases 9-11 use the same mesh, whatever the machine shows)
    mesh = psh.make_mesh(8, dev)
    run_checks(torch, small_cases(torch, dev, kern, dk, drk, convert),
               "small", on_cuda, timed=False)
    run_checks(torch, mesh_small_cases(torch, dev, kern, dk, drk, psh,
                                       convert, mesh),
               "small", on_cuda, timed=False)
    run_checks(torch, calc_edge_cases(torch, kern, dk, convert, dev),
               "small", on_cuda, timed=False)
    # K6 dense splits a group past the members a launch takes by value
    group = [convert.tables_from_numpy({"drain": small_drain(500 + k, 9)[0]},
                                       dev)["drain"] for k in range(130)]
    l0 = kern.LAUNCHES["fused_frontier_dense"]
    check(bool(torch.equal(kern.fused_frontier_dense(group).cpu(),
                           drk.fused_ready_frontier_plain(group).cpu())),
          "K6 dense over 130 members != plain")
    check(not on_cuda or not k6_by_value(kern)
          or kern.LAUNCHES["fused_frontier_dense"] - l0 == 2,
          "K6 dense over 130 members: not two launches")
    # K2's token gather past its by-value capacity, None slices, int32 and
    # int64 codes; 40 shards take two launches
    run_checks(torch, {f"attr_tok[{tag}]": tok_case(
        torch, kern, psh, *tok_edge_inputs(torch, dev, *spec, seed=70 + k))
        for k, (tag, spec) in enumerate(TOK_EDGES.items())},
        "small", on_cuda, timed=False)
    l0 = kern.LAUNCHES["attr_tok"]
    kern.attr_tok(*tok_edge_inputs(torch, dev, 40, False, True, seed=79))
    check(not on_cuda or not hasattr(kern, "TOK_MAX_REFS")
          or kern.LAUNCHES["attr_tok"] - l0 == 2,
          "attr_tok over 40 shards: not two launches")
    # K7 ELL takes the first CTA's form under each of its caps, the grid
    # over them and on 131,072 Stable rows
    if on_cuda and hasattr(kern, "level_ell_stats"):
        forms = {f"cap {k}": (f, form)
                 for k, (f, form) in LEVEL_ELL_CAPS.items()}
        forms["all stable 131072"] = (lambda: stable_dag_ell(131072),
                                      "grid")
        for tag, (f, form) in forms.items():
            got = level_ell_form(kern, convert.tables_from_numpy(
                {"ell": f()}, dev)["ell"])
            check(got["form"] == form,
                  f"K7 ELL {tag}: the {got['form']} form, not the {form}: "
                  f"{got}")
            log(f"K7 ELL {tag}: " + json.dumps(got))
    log(f"phase3a: small checks done at {time.perf_counter() - t_start:.1f}"
        " s")

    # setup for the main path (host side, untimed)
    N, KEYSPACE, M, B = ((100_000, 1_000_000, 8, 2048) if not rehearsal
                         else (3_000, 1_000_000, 8, 128))
    n_batches = 6
    ND = 100_000 if not rehearsal else 12_000
    t0 = time.perf_counter()
    entries = build_workload(np.random.default_rng(42), N, KEYSPACE, M, P)
    store, ds, safe = build_store(entries, KEYSPACE, dev)
    ds.route_override = "device"
    batches = [make_queries(1000 + i, B, KEYSPACE, M, P,
                            wide_frac=0.1 if i == n_batches - 1 else 0.0)
               for i in range(n_batches)]
    extra = build_workload(np.random.default_rng(7), 3 * B, KEYSPACE, M, P)
    log(f"setup: store of {N} txns (capacity {ds.deps.capacity}, "
        f"{ds.deps.max_intervals} intervals, {len(ds.deps.bucket_entries)} "
        f"buckets, keff {ds.deps.bucket_keff()}) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dstore, dds = drain_store(ND, dev)
    log(f"setup: drain store of {ND} rows ({len(dstore.records)} armed) in "
        f"{time.perf_counter() - t0:.1f} s")
    # the fused phase's stores: config 5's harness (bench.py:600-714), two
    # more drain stores like phase 5's (ELL) and two small ones (dense) for
    # fused ticks; and bench config 3's serial chain (NDD, bench.py:463)
    S5, NPER5, KEYS5 = (16, 2048, 4096) if not rehearsal else (4, 128, 256)
    ROUNDS5, WARM5 = (48, 4) if not rehearsal else (4, 2)
    NDT = 4_000 if not rehearsal else 300
    NDD = 4096 if not rehearsal else 64
    t0 = time.perf_counter()
    fnode, fdevs = launch_harness(S5, NPER5, KEYS5, True, dev)
    tick_ell = [drain_store(ND, dev, seed=sd) for sd in (13, 17)]
    tick_dense = [drain_store(NDT, dev, seed=sd) for sd in (19, 23)]
    # and two more, for two fused dense ticks in flight at once
    tick_dense2 = [drain_store(NDT, dev, seed=sd) for sd in (29, 31)]
    cstore, cds, cchain = chain_store(NDD, dev)
    log(f"setup: {S5} x {NPER5} fused-flush stores, 2 x {ND} + 2 x {NDT} "
        f"fused-tick drain stores, a {NDD}-deep chain store in "
        f"{time.perf_counter() - t0:.1f} s")

    # warm pass: uploads, learned s/k budgets, and one maintenance step,
    # recording the kernels' arguments at the main path's shapes
    rec = Recorder(kern)
    try:
        for batch in batches:
            attributed(ds, safe, batch)
        register(ds, store, extra[:B])
        attributed(ds, safe, batches[0])
        dstate, _live = dds.drain.state()   # what phase 5's first tick sweeps
    finally:
        rec.restore()
    # the fused harness's warm rounds (uploads, learned budgets), recording
    # the fused kernels' arguments at the fused phase's shapes
    rec7 = Recorder(kern, ["fused_deps_dense", "fused_attr_post"])
    rec7f = Recorder(dk, ["fused_flat_attr"])   # and the whole flush call
    try:
        drive_flushes(fnode, fdevs, WARM5, KEYS5, seed=5)
    finally:
        rec7f.restore()
        rec7.restore()
    check(fnode.dispatcher.n_fused_launches > 0,
          "fused warm pass: the pricing never chose a fused flush "
          f"({fnode.dispatcher.n_solo_flushes} solo)")
    ell_pair = [d.drain.state()[0] for _st, d in tick_ell]
    dense_pair = [d.drain.state()[0] for _st, d in tick_dense]
    cstate, _live = cds.drain.state()
    check(isinstance(ell_pair[0], drk.EllDrainState)
          and isinstance(dense_pair[0], drk.DrainState)
          and isinstance(cstate, drk.DrainState),
          "fused-tick / chain stores took the wrong drain form")
    check(set(rec.calls) >= {"deps_bucketed", "deps_dense", "attr_post",
                             "scatter_rows"},
          f"warm pass missed kernels: {sorted(rec.calls)}")
    # phase 8's inputs: bench config 3 at its specified scale, the hot store
    # and then the drain legs from the same seeded stream
    N3, B3, HOT3 = (100_000, 256, 128) if not rehearsal else (2_000, 16, 16)
    ND3, CH3, NDD3 = ((100_000, 512, 4096) if not rehearsal
                      else (2_000, 32, 256))
    t0 = time.perf_counter()
    hstore, hdev, hsafe, hqueries, hbuild_rate, hrng = build_hot128_store(
        dev, N3, B3, HOT3)
    ell3, dense3, dense3_ell, rows3, deep_edges3 = hot_drain_legs(
        hrng, convert, dev, ND3, CH3, NDD3)
    log(f"setup: config-3 hot store of {N3} txns over {HOT3} keys "
        f"(registration {hbuild_rate:.0f} txn/s), drain legs {ND3} x "
        f"{ell3.adj_idx.shape[1]} and a {NDD3}-deep chain "
        f"({dense3_ell.adj_idx.shape[1]} wide as ELL) in "
        f"{time.perf_counter() - t0:.1f} s")

    # 3b. real-size kernel checks and timings at the recorded shapes
    real = {}
    a, kw, _w = rec.calls["deps_bucketed"]
    real["deps_bucketed"] = bucket_case(torch, kern, dk, *a, **kw)
    a, kw, _w = rec.calls["deps_dense"]
    real["deps_dense"] = dense_case(torch, kern, dk, *a, **kw)
    a, kw, _w = rec.calls["attr_post"]
    real["attr_post"] = attr_case(torch, kern, dk, *a, **kw)
    a, kw, _w = rec.calls["scatter_rows"]
    real["scatter_rows"] = scatter_case(torch, kern, dk, *a, **kw)
    # K3's live form, as the mirrors call it (numpy in: one packed upload
    # and one launch), at the largest recorded call and at P = 8 rows of
    # the store's table, as the burn's flushes scatter them
    real["scatter_rows[live]"] = scatter_case(torch, kern, dk, *a, **kw,
                                              live=True)
    real["scatter_rows[live P8]"] = scatter_case(torch, kern, dk,
                                                 *table_rows(ds), live=True)
    real["frontier_ell"] = ell_case(torch, kern, drk, dstate)
    # and as the solo ELL tick pays for it (a new state a call, into a
    # pinned buffer, one sync; an earlier tree: its launch and .cpu())
    real["frontier_ell[tick]"] = ell_case(torch, kern, drk, dstate,
                                          tick=on_cuda)
    a, kw, _w = rec7.calls["fused_deps_dense"]
    real["fused_deps_dense"] = fused_scan_case(torch, kern, dk, *a, **kw)
    a, kw, _w = rec7.calls["fused_attr_post"]
    real["fused_attr_post"] = fused_attr_case(torch, kern, dk, *a, **kw)
    real["fused_frontier_ell"] = fused_frontier_case(torch, kern, drk,
                                                     ell_pair)
    real["fused_frontier_ell[tick]"] = fused_frontier_case(
        torch, kern, drk, ell_pair, tick=on_cuda)
    real["fused_frontier_dense"] = fused_frontier_case(torch, kern, drk,
                                                       dense_pair)
    real["level_ell"] = level_case(torch, kern, drk, dstate)
    real["level_dense"] = level_case(torch, kern, drk, cstate)
    # K7 ELL at phase 8's states (the 100k drain, the chain in ELL form),
    # 131,072 Stable rows of 8 deps (the grid form), and the first CTA's:
    # the 1,024-row chain and phase 3's random inputs
    ell_more = {
        "phase8 100k": ell3, "phase8 chain": dense3_ell,
        "all stable 131072": convert.tables_from_numpy(
            {"ell": stable_dag_ell(131072 if not rehearsal else 4096)},
            dev)["ell"],
        "chain1024": chain_states(convert, dev, 1024)[1],
        **{f"n{n}": convert.tables_from_numpy(
            {"ell": small_drain(seed, n)[1]}, dev)["ell"]
           for seed, n in ((3, 64), (4, 512), (8, 48))}}
    for tag, st in ell_more.items():
        real[f"level_ell[{tag}]"] = level_case(torch, kern, drk, st)
    # K6 dense on one planned group (repeated calls, no checks a call);
    # K7 dense past the first CTA's rows (a chain twice as deep: the grid
    # form), at the first CTA's shared-memory cap, and on phase 3's random
    # inputs
    real["fused_frontier_dense[planned]"] = fused_frontier_case(
        torch, kern, drk, [kern.checked_cols(st) for st in dense_pair])
    k7_inputs = {"chain8192": chain_states(convert, dev, 2 * NDD)[0],
                 "dag1024x30": convert.tables_from_numpy(
                     {"drain": random_dag(1024, 30, 7)}, dev)["drain"],
                 **{f"n{n}": convert.tables_from_numpy(
                     {"drain": small_drain(seed, n)[0]}, dev)["drain"]
                    for seed, n in ((3, 64), (4, 512), (8, 48))}}
    for tag, st in k7_inputs.items():
        real[f"level_dense[{tag}]"] = level_case(torch, kern, drk, st)
    # K8-K10 at phase 8's shapes: the 100k ELL drain, the 4,096-deep chain
    real["drain_fix_ell"] = fix_case(torch, kern, drk, ell3)
    # and on narrow levels between wide ones (phase 3's 120,000 rows):
    # the grid on the wide levels, the first CTA on the narrow
    ell_ntw = convert.tables_from_numpy({"ell": levels_ell(
        (600, 30_000, 2, 30_000, 1), 120_000, 26)}, dev)["ell"]
    real["drain_fix_ell[narrow then wide]"] = fix_case(torch, kern, drk,
                                                       ell_ntw)
    real["drain_fix_dense"] = fix_case(torch, kern, drk, dense3)
    # K4b at config 3's [4096, 4096], planned: the adjacency-bound size
    real["frontier_dense[4096]"] = dense_frontier_case(
        torch, kern, drk, kern.checked_cols(dense3))
    # and on a wide input: 4 antichains of NDD3 / 4 rows, 5 sweeps
    wide3 = wide_drain_input(convert, dev, NDD3)
    real["drain_fix_dense[wide]"] = fix_case(torch, kern, drk, wide3)
    # and two narrow levels before two wide ones: the frontier form's
    # first CTA alone on the wide levels
    real["drain_fix_dense[narrow then wide]"] = fix_case(
        torch, kern, drk, convert.tables_from_numpy(
            {"drain": levels_graph((2, 1, NDD3 // 2 - 2, NDD3 // 2 - 1),
                                   NDD3, 17)}, dev)["drain"])
    real["logsq_dense"] = logsq_case(torch, kern, drk, dense3)
    # and on an input that is dense from the first squaring, against the
    # dense bound: the product's own efficiency
    real["logsq_dense[dense input]"] = logsq_case(
        torch, kern, drk,
        logsq_dense_input(convert, dev, dense3.status.shape[0]))
    # the log-depth drains (K7 with K9's epilogue; on an earlier tree the
    # K7 call and the K9 call): phase 8's 100k ELL rows (the grid form) and
    # chain in ELL form (the first CTA), config 3's chain in dense form
    # (the first CTA), an 8,192-deep chain (dense's grid form), phase 3's
    # random inputs, and the watermark forms (an int, a 0-d tensor on the
    # card) on the chain and on 131,072 Stable rows (ELL's grid form)
    wt = torch.tensor(NDD3 // 2, device=dev)
    drain_inputs = {
        "level_drain": (ell3, None),
        "level_drain[phase8 chain]": (dense3_ell, None),
        "level_drain[config3 chain dense]": (cstate, None),
        "level_drain[chain8192 dense]": (k7_inputs["chain8192"], None),
        "level_drain[phase8 chain w=int]": (dense3_ell, NDD3 // 2),
        "level_drain[phase8 chain w=tensor]": (dense3_ell, wt),
        "level_drain[config3 chain dense w=int]": (cstate, NDD3 // 2),
        "level_drain[config3 chain dense w=tensor]": (cstate, wt),
        "level_drain[all stable 131072 w=tensor]": (
            ell_more["all stable 131072"], torch.tensor(
                77, dtype=torch.int32, device=dev)),
        **{f"level_drain[n{n}]": (ell_more[f"n{n}"], None)
           for n in (64, 512, 48)}}
    for name, (st, w) in drain_inputs.items():
        real[name] = level_drain_case(torch, kern, drk, st, w)
    real["dense_degree"] = degree_case(torch, kern, drk, dense3.adj)
    real["dense_to_ell"] = to_ell_case(torch, kern, drk, dense3.adj,
                                       dense3_ell.adj_idx.shape[1])
    # K10 at the router's probe (a 256-row chain, d = 4), and through the
    # generic launcher on the same input as the wrapper's
    probe = drk._probe_chain_dense(256, dev)
    real["dense_to_ell[probe 256 d=4]"] = to_ell_case(torch, kern, drk,
                                                      probe.adj, 4)
    if on_cuda:
        real["dense_to_ell[via _launch]"] = to_ell_case(
            torch, kern, drk, dense3.adj, dense3_ell.adj_idx.shape[1],
            launch=True)
    rows = run_checks(torch, real, "real", on_cuda, timed=True)
    # K1a's rows at its largest recorded call: candidates, valid, unique
    k1a_rows = {"largest": bucket_row_stats(
        torch, dk, *rec.calls["deps_bucketed"][:2])}
    fix_sweeps = {tag: int(kern.drain_fix_dense(st)[2]) for tag, st in (
        ("chain", dense3), ("wide", wide3))}
    fix_sweeps["ell_100k"] = int(kern.drain_fix_ell(ell3)[2])
    log("K1a rows: " + json.dumps(k1a_rows) + "; K8 sweeps: "
        + json.dumps(fix_sweeps))
    pack_t = pack_timings(torch, kern, dk, *rec.calls["scatter_rows"][0],
                          on_cuda)
    level_rounds = {
        "ell_100k": int(drk.level_assign_ell_plain(dstate)[1]),
        "dense_chain": int(drk.level_assign_dense_plain(cstate)[1])}
    log("level pass rounds (plain, the same as the kernels'): "
        + json.dumps(level_rounds))
    k7_ell_forms = ({tag: level_ell_form(kern, st) for tag, st in
                     {"phase5 first tick": dstate, **ell_more}.items()}
                    if on_cuda else {})
    log("K7 ELL on the real inputs (rows n, width d, Stable rows A, list "
        "entries E, form, rounds): " + json.dumps(k7_ell_forms))
    shapes = {
        "deps_bucketed": list(rec.calls["deps_bucketed"][0][2].shape),
        "deps_dense": list(rec.calls["deps_dense"][0][1].shape),
        "attr_post": [int(rec.calls["attr_post"][0][5].shape[0])],
        "scatter_rows": [len(rec.calls["scatter_rows"][0][1])],
        "scatter_rows[live]": [len(rec.calls["scatter_rows"][0][1]),
                               len(rec.calls["scatter_rows"][0][0])],
        "scatter_rows[live P8]": [8, 7],
        "frontier_ell": list(dstate.adj_idx.shape),
        "frontier_ell[tick]": list(dstate.adj_idx.shape),
        "fused_deps_dense": list(rec7.calls["fused_deps_dense"][0][1].shape)
        + [max(t.lo.shape[0] for t in rec7.calls["fused_deps_dense"][0][0])],
        "fused_attr_post": list(rec7.calls["fused_attr_post"][0][5].shape),
        "fused_frontier_ell": [len(ell_pair)] + list(ell_pair[0].adj_idx.shape),
        "fused_frontier_ell[tick]": [len(ell_pair)]
        + list(ell_pair[0].adj_idx.shape),
        "fused_frontier_dense": [len(dense_pair)]
        + list(dense_pair[0].adj.shape),
        "level_ell": list(dstate.adj_idx.shape),
        "level_dense": list(cstate.adj.shape),
        "fused_frontier_dense[planned]": [len(dense_pair)]
        + list(dense_pair[0].adj.shape),
        **{f"level_dense[{tag}]": list(st.adj.shape)
           for tag, st in k7_inputs.items()},
        **{f"level_ell[{tag}]": list(st.adj_idx.shape)
           for tag, st in ell_more.items()},
        "drain_fix_ell": list(ell3.adj_idx.shape),
        "drain_fix_ell[narrow then wide]": list(ell_ntw.adj_idx.shape),
        "drain_fix_dense": list(dense3.adj.shape),
        "frontier_dense[4096]": list(dense3.adj.shape),
        "drain_fix_dense[wide]": list(wide3.adj.shape),
        "drain_fix_dense[narrow then wide]": [NDD3, NDD3],
        "logsq_dense": list(dense3.adj.shape),
        **{name: [int(st.status.shape[0])]
           for name, (st, _w) in drain_inputs.items()},
        "dense_degree": list(dense3.adj.shape),
        "dense_to_ell": list(dense3_ell.adj_idx.shape),
        "dense_to_ell[probe 256 d=4]": [256, 4],
        "dense_to_ell[via _launch]": list(dense3_ell.adj_idx.shape)}

    # 4-11. the main path, with every launch count set to 0 first, and
    # the payload of each K3 call noted
    sizes = ScatterSizes(torch, kern, dk)
    kern.reset_launches()
    phase_launches = {}
    phase_seconds = {}
    seen = dict(kern.LAUNCHES)
    # the fused epilogues' calls (K9's inside K7's launch), not launches
    epilogues = getattr(kern, "EPILOGUES", {})
    phase_epilogues = {}
    seen_epi = dict(epilogues)
    t_phase = [time.perf_counter()]

    def phase_done(tag):
        phase_launches[tag] = {k: v - seen[k] for k, v in kern.LAUNCHES.items()}
        seen.update(kern.LAUNCHES)
        phase_epilogues[tag] = {k: v - seen_epi[k]
                                for k, v in epilogues.items()}
        seen_epi.update(epilogues)
        now = time.perf_counter()
        phase_seconds[tag] = now - t_phase[0]
        t_phase[0] = now
        log(f"phase{tag}: {phase_seconds[tag]:.1f} s")

    # 4. the deps store at real size
    before = {k: getattr(ds, k) for k in (
        "n_bucketed_queries", "n_dense_queries", "n_host_queries",
        "n_device_faults", "n_fallback_queries", "n_quarantines")}
    keep = {0: None, n_batches - 1: None}
    kt0 = {k: tuple(v) for k, v in ds.kernel_times.items()}
    t0 = time.perf_counter()
    pending = []

    spent = {"begin": 0.0, "end_attributed": 0.0, "build": 0.0}

    def collect(i, handle, batch):
        builders = [P.DepsBuilder() for _ in batch]
        t1 = time.perf_counter()
        ds.deps_query_batch_end_attributed(safe, handle, builders)
        t2 = time.perf_counter()
        for bld in builders:                 # the frozen Deps
            bld.build()
        spent["end_attributed"] += t2 - t1
        spent["build"] += time.perf_counter() - t2
        if i in keep:
            keep[i] = builders

    for i, batch in enumerate(batches):
        t1 = time.perf_counter()
        handle = ds.deps_query_batch_begin(batch, prune_floors=True,
                                           attributed=True)
        spent["begin"] += time.perf_counter() - t1
        pending.append((i, handle, batch))
        if len(pending) >= 2:
            collect(*pending.pop(0))
    while pending:
        collect(*pending.pop(0))
    if on_cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nq = B * n_batches
    # where the pass's wall time went, by launch boundary (dispatch_* =
    # host pack + upload + enqueue, wait_* = download joins, host_* =
    # host passes): [calls, ms]
    breakdown = {}
    for k, (c, sec) in sorted(ds.kernel_times.items()):
        c0, s0 = kt0.get(k, (0, 0.0))
        breakdown[k] = [c - c0, round((sec - s0) * 1e3, 3)]
    delta = {k: getattr(ds, k) - v for k, v in before.items()}
    log(f"phase4: {nq} queries in {dt:.3f} s = {nq / dt:.1f} queries/s "
        f"(device route, pipelined 2 deep, protocol-complete Deps) "
        + json.dumps(delta))
    log("phase4: wall by step [s] " + json.dumps(
        {k: round(v, 4) for k, v in spent.items()}))
    keep = {i: deps_digest(b) for i, b in keep.items()}
    check(delta["n_bucketed_queries"] + delta["n_dense_queries"] == nq,
          f"bucketed + dense != {nq}: {delta}")
    check(delta["n_dense_queries"] > 0 and delta["n_bucketed_queries"] > 0,
          f"both device kernels must serve queries: {delta}")
    check(delta["n_host_queries"] == 0, f"host queries: {delta}")
    check(delta["n_device_faults"] == 0 and delta["n_fallback_queries"] == 0
          and delta["n_quarantines"] == 0, f"device faults: {delta}")
    # the host route answers two of the batches with the same Deps, on the
    # same store state (no mutation since the device pass)
    ds.route_override = "host"
    for i, want in keep.items():
        got_h = deps_digest(attributed(ds, safe, batches[i]))
        check(got_h == want, f"batch {i}: device Deps != host route Deps")
        check(sum(len(k) + len(r) for k, r in got_h) > 0,
              f"batch {i}: empty Deps")
    ds.route_override = "device"
    log(f"phase4: device Deps == host-route Deps on batches {sorted(keep)}")
    # live maintenance: registrations between batches (dirty-row scatters)
    t0 = time.perf_counter()
    for j in (1, 2):
        register(ds, store, extra[j * B:(j + 1) * B])
        attributed(ds, safe, batches[j])
    log(f"phase4: live maintenance {2 * B} registrations + {2 * B} queries "
        f"in {time.perf_counter() - t0:.3f} s")
    check(ds.n_host_queries == before["n_host_queries"] + 2 * B,
          "maintenance queries took the host route")
    phase_done("4")
    log("phase4: host/device time by launch boundary [calls, ms] "
        + json.dumps(breakdown))
    # what each K7 ELL call of phases 5 and 8 found (A, E, its form)
    k7_ell_calls = {}
    lstats = LevelStats(kern, on_cuda)

    # 5. the drain at real size, through the store's drain tick: the tick
    # DeviceState.arm scheduled sweeps the cached device state (ELL above
    # DENSE_MAX live rows) and proposes the ready txns; then 2,000
    # dependencies are applied (the drain half of update_status: scalar
    # deltas, a dirty-row scatter) and a second tick sweeps again.  Each
    # tick's proposals must equal the plain version's frontier
    def expect_proposed():
        st, live = dds.drain.state()          # the state the tick swept
        ready = drk.ready_frontier_ell_plain(st)[:len(live)].cpu().numpy()
        return st, {dds.drain.id_of[int(x)]
                    for x in live[ready & dds.drain.active[live]]}

    t0 = time.perf_counter()
    ticks0 = (dds.n_device_ticks, dds.n_host_ticks)
    dstore.run_ticks()
    st, want = expect_proposed()
    check(isinstance(st, drk.EllDrainState),
          "phase5: the drain tick must take the ELL form")
    check(dstore.ticks == [("ell", len(want))] and dstore.proposed == want,
          f"phase5: tick 1 proposals != plain ({dstore.ticks})")
    n_ready = len(want)
    rng = np.random.default_rng(12)
    pending = [tid for tid in dds.drain.slot_of
               if tid not in dstore.records
               and int(dds.drain.status[dds.drain.slot_of[tid]]) in (1, 3)]
    for k in rng.choice(len(pending), min(2000, len(pending)),
                        replace=False):
        tid = pending[int(k)]
        dds.drain.set_status(dds.drain.slot_of[tid], 5, tid)
    dds.schedule_tick()
    dstore.run_ticks()
    _st, want = expect_proposed()
    check(dstore.ticks[-1] == ("ell", len(want)) and dstore.proposed == want,
          f"phase5: tick 2 proposals != plain ({dstore.ticks})")
    check((dds.n_device_ticks - ticks0[0], dds.n_host_ticks - ticks0[1])
          == (2, 0), "phase5: the ticks must run on the device")
    if on_cuda:
        torch.cuda.synchronize()
    log(f"phase5: {ND} x {st.adj_idx.shape[1]} drain, 2 device ticks, "
        f"{n_ready} -> {len(want)} proposed after "
        f"{min(2000, len(pending))} applied deps, "
        f"{time.perf_counter() - t0:.3f} s")
    check(rehearsal or kern.LAUNCHES["frontier_ell"] - seen["frontier_ell"]
          == 2, f"phase5: frontier_ell launches {kern.LAUNCHES}")
    # the widened wavefront: a bench-config-3-deep serial chain armed
    # among the 100k rows, and the store executing what it is proposed
    # (every txn whose gating deps have applied applies at once: the
    # synchronous-cascade regime).  W doubles each tick, the level pass
    # (level_ell) proposes the next W antichains, and the chain applies in
    # O(log depth) ticks; everything applied equals the plain level pass
    chain_bound = int(np.log2(NDD)) + 4
    dstore.ds = dds
    dstore.apply = True
    chain5 = add_chain(dstore, dds, NDD, 10_000_000)
    st5, live5 = dds.drain.state()
    lv5 = drk.level_assign_ell_plain(st5)[0].cpu().numpy()[:len(live5)]
    want5 = {dds.drain.id_of[int(x)] for x in
             live5[(lv5 >= 1) & (lv5 < drk.LEVEL_INF)
                   & dds.drain.active[live5]]}

    def drain_chain(dstore_, ds_, chain_ids, limit=64):
        """Tick until idle: (ticks until the chain applied, ticks, the
        largest W reached)."""
        dstore_.applied = []
        done_at, ticks, wmax = None, 0, ds_._drain_wavefront
        while dstore_.due and ticks < limit:
            dstore_.run_ticks()
            ticks += 1
            wmax = max(wmax, ds_._drain_wavefront)
            if done_at is None and set(chain_ids) <= set(dstore_.applied):
                done_at = ticks
        return done_at, ticks, wmax

    t0 = time.perf_counter()
    w0 = dds.n_wavefront_ticks
    chain_at, n_ticks5, wmax5 = drain_chain(dstore, dds, chain5)
    log(f"phase5: {NDD}-deep chain among {len(live5)} live ELL rows "
        f"applied after {chain_at} ticks ({n_ticks5} ticks to idle, "
        f"{dds.n_wavefront_ticks - w0} widened, W up to {wmax5}, "
        f"{len(dstore.applied)} txns applied) in "
        f"{time.perf_counter() - t0:.3f} s")
    check(chain_at is not None and chain_at <= chain_bound,
          f"phase5: the chain took {chain_at} ticks (bound {chain_bound})")
    check(set(dstore.applied) == want5,
          f"phase5: applied {len(dstore.applied)} != plain level pass "
          f"{len(want5)}")
    check(dds.n_wavefront_ticks > w0 and wmax5 >= 2 ** (chain_at - 1),
          "phase5: the wavefront did not widen")
    # the same on bench config 3's chain alone: a dense drain state, so
    # the dense frontier and the dense level pass
    cstore.apply = True
    t0 = time.perf_counter()
    wc0 = cds.n_wavefront_ticks
    chain_c, n_ticks_c, wmax_c = drain_chain(cstore, cds, cchain)
    log(f"phase5: {NDD}-deep chain alone (dense) applied after {chain_c} "
        f"ticks ({n_ticks_c} to idle, {cds.n_wavefront_ticks - wc0} "
        f"widened, W up to {wmax_c}) in {time.perf_counter() - t0:.3f} s")
    check(chain_c is not None and chain_c <= chain_bound
          and cstore.applied == cchain,
          f"phase5: the dense chain took {chain_c} ticks")
    phase_done("5")
    lstats.restore()
    k7_ell_calls["5"] = lstats.calls
    for k_ in ("frontier_ell", "level_ell", "frontier_dense", "level_dense"):
        check(rehearsal or phase_launches["5"][k_] > 0,
              f"phase5: {k_} never launched {phase_launches['5']}")

    # 6. the protocol
    n_ops = 150 if not rehearsal else 20
    t0 = time.perf_counter()
    rec6 = Recorder(kern, ["frontier_dense"])   # the dense ticks' largest
    # every K1a, K1b and K2 call of the burn, to time each at its median
    # call
    med6 = MedianRecorder(kern, ["deps_bucketed", "deps_dense",
                                 "attr_post", "fused_deps_dense",
                                 "fused_attr_post", "fused_frontier_dense"])
    try:
        r1, c1, d1 = burn_once(run_burn, dev, n_ops)
    finally:
        med6.restore()
        rec6.restore()
    t1 = time.perf_counter()
    # the second run, with no recorder in the way: each solo dense tick's
    # dispatch and wait
    from accord_tpu_torch.local.device_index import _DrainMirror
    ticks6 = DenseTickTimes(kern, P.DeviceState, _DrainMirror, drk)
    try:
        r2, c2, d2 = burn_once(run_burn, dev, n_ops)
    finally:
        ticks6.restore()
    t2 = time.perf_counter()
    log(f"phase6: burn seed 1, {n_ops} ops: {r1} in {t1 - t0:.1f} s and "
        f"{t2 - t1:.1f} s; " + json.dumps(c1))
    check(r1.ops_unresolved == 0 and r1.ops_ok > 0, f"burn: {r1}")
    check(c1["n_bucketed_queries"] + c1["n_dense_queries"] > 0,
          "burn: no kernel deps flushes")
    check(c1["n_device_ticks"] > 0, "burn: no device drain ticks")
    check(c1["n_host_ticks"] == 0, f"burn: host ticks {c1['n_host_ticks']}")
    check(c1["n_device_faults"] == 0 and c1["n_host_queries"] == 0
          and c1["n_quarantines"] == 0,
          f"burn: faults or host queries {c1}")
    check(not any(k.startswith("DeviceFault.") for k in r1.stats),
          "burn: fault events in the stats")
    check(d1 == d2 and c1 == c2, "burn: two runs of seed 1 differ")
    check(rehearsal or d1.startswith(BURN_DIGEST),
          f"burn: digest {d1[:16]} != {BURN_DIGEST}")
    log(f"phase6: digest {d1[:16]} equal across two runs; default "
        f"configuration: {r1.stats.get('device_fused_launches')} fused "
        f"flush launches ({c1['n_fused_flushes']} member flushes), "
        f"{r1.stats.get('device_fused_tick_launches')} fused tick launches "
        f"({c1['n_fused_ticks']} member ticks), {c1['n_wavefront_ticks']} "
        f"widened ticks; solo dense ticks of the second run "
        + json.dumps(ticks6.summary()))
    phase_done("6")

    # 7. fused launches.  Flushes: config 5's harness, fusion off then on,
    # the same queries; per-store Deps equal, and the launches a fused
    # flush makes do not grow with the number of stores it serves
    disp = fnode.dispatcher
    fused7 = {}
    for mode, fusion in (("solo", False), ("fused", True)):
        disp.fusion = fusion
        l0 = dict(kern.LAUNCHES)
        f0, s0 = disp.n_fused_launches, disp.n_solo_flushes
        t0 = time.perf_counter()
        built = drive_flushes(fnode, fdevs, ROUNDS5, KEYS5, seed=7)
        if on_cuda:
            torch.cuda.synchronize()
        dt7 = time.perf_counter() - t0
        nq7 = ROUNDS5 * S5 * 4
        flushes = (disp.n_fused_launches - f0) + (disp.n_solo_flushes - s0)
        kl = sum(kern.LAUNCHES[k] - l0[k] for k in kern.KERNELS)
        fused7[mode] = {"txn_per_s": nq7 / dt7, "queries": nq7,
                        "launches_per_1k_txn": 1e3 * flushes / nq7,
                        "kernel_launches_per_1k_txn": 1e3 * kl / nq7,
                        "fused_launches": disp.n_fused_launches - f0,
                        "digest": [deps_digest(b) for b in built]}
    check(fused7["solo"]["digest"] == fused7["fused"]["digest"],
          "phase7: fused per-store Deps != solo Deps")
    check(sum(len(k) + len(r) for st_ in fused7["solo"]["digest"]
              for k, r in st_) > 0, "phase7: empty Deps")
    check(fused7["solo"]["fused_launches"] == 0
          and fused7["fused"]["fused_launches"] == ROUNDS5,
          f"phase7: fused launches {fused7['fused']['fused_launches']} "
          f"for {ROUNDS5} rounds")
    per_flush = {}
    for n_st in (S5, max(S5 // 4, 2)):
        l0 = dict(kern.LAUNCHES)
        f0 = disp.n_fused_launches
        drive_flushes(fnode, fdevs[:n_st], 4, KEYS5, seed=9)
        per_flush[n_st] = (
            (kern.LAUNCHES["fused_deps_dense"] - l0["fused_deps_dense"]
             + kern.LAUNCHES["fused_attr_post"] - l0["fused_attr_post"])
            / max(disp.n_fused_launches - f0, 1))
    check(rehearsal or len(set(per_flush.values())) == 1,
          f"phase7: kernel launches per fused flush grow with S: "
          f"{per_flush}")
    # the solo leg once more, untimed and left out of the phase's launch
    # counts, to record its largest K1b call (the dense route of each
    # store's flush)
    disp.fusion = False
    l0 = dict(kern.LAUNCHES)
    rec7s = Recorder(kern, ["deps_dense"])
    try:
        drive_flushes(fnode, fdevs, ROUNDS5, KEYS5, seed=7)
    finally:
        rec7s.restore()
        disp.fusion = True
    for k_ in seen:
        seen[k_] += kern.LAUNCHES[k_] - l0[k_]
    for mode in ("solo", "fused"):
        del fused7[mode]["digest"]
    log(f"phase7: config-5 harness, {S5} stores x {NPER5} txns, 4-query "
        f"flushes, {ROUNDS5} rounds: " + json.dumps(fused7)
        + "; kernel launches per fused flush by S " + json.dumps(per_flush))
    # fused ticks: two drain stores per group on one dispatcher, one fused
    # sweep each; every store's proposals equal its plain frontier
    tnode = TickNode()
    for group, plain, mode_ in ((tick_ell, drk.ready_frontier_ell_plain,
                                 "ell"),
                                (tick_dense, drk.ready_frontier_plain,
                                 "dense")):
        for sid, (st_, d_) in enumerate(group):
            st_.node, st_.store_id = tnode, sid
            st_.due, st_.ticks, st_.proposed = [], [], set()
            d_._tick_scheduled = False
        for _st, d_ in group:
            d_.schedule_tick()
        f0 = tnode.dispatcher.n_fused_tick_launches
        tnode.scheduler.run()
        check(tnode.dispatcher.n_fused_tick_launches == f0 + 1,
              f"phase7: no fused {mode_} tick (pricing or eligibility)")
        for st_, d_ in group:
            s_, live_ = d_.drain.state()
            ready_ = plain(s_)[:len(live_)].cpu().numpy()
            want_ = {d_.drain.id_of[int(x)]
                     for x in live_[ready_ & d_.drain.active[live_]]}
            check(st_.ticks == [("fused", len(want_))]
                  and st_.proposed == want_,
                  f"phase7: fused {mode_} tick proposals != plain "
                  f"({st_.ticks})")
        log(f"phase7: one fused {mode_} tick over "
            f"{[d_.drain.state()[0].status.shape[0] for _s, d_ in group]} "
            f"rows proposed {[t for st_, _d in group for t in st_.ticks]}")
    phase_done("7")
    check(rehearsal or phase_launches["7"]["fused_deps_dense"] > 0,
          "phase7: fused_deps_dense never launched")

    lstats = LevelStats(kern, on_cuda)
    try:
        phase8 = hot_keys_phase(torch, drk, hstore, hdev, hsafe, hqueries,
                                B3, ell3, dense3, dense3_ell, rows3,
                                deep_edges3, dev, rehearsal)
    finally:
        lstats.restore()
    k7_ell_calls["8"] = lstats.calls
    phase8["registration_txn_per_s"] = hbuild_rate
    phase_done("8")
    for tag, calls in k7_ell_calls.items():
        log(f"phase{tag}: K7 ELL calls (rows n, Stable rows A, list entries "
            "E, form, rounds): " + json.dumps(
                [[c["n"], c["A"], c["E"], c["form"], c["rounds"]]
                 for c in calls]))
    for k_ in ("drain_fix_dense", "drain_fix_ell", "logsq_dense",
               "dense_degree", "dense_to_ell") + (
                   () if fused_k9(kern) else ("level_drain",)):
        check(rehearsal or phase_launches["8"][k_] > 0,
              f"phase8: {k_} never launched {phase_launches['8']}")
    if fused_k9(kern):
        # K9 ran as K7's epilogue, never as a launch of its own
        check(rehearsal or phase_epilogues["8"]["level_drain"] > 0,
              f"phase8: the level-drain epilogue never ran "
              f"{phase_epilogues['8']}")
        check("level_drain" not in kern.LAUNCHES
              and not hasattr(kern, "level_drain"),
              "phase8: a standalone K9 level_drain launch exists")
        log("phase8: K7 launches with K9's epilogue: "
            + json.dumps(phase_epilogues["8"]) + ", K7 launches "
            + json.dumps({k_: phase_launches["8"][k_]
                          for k_ in ("level_ell", "level_dense")}))

    # 9-11. the mesh path (8 slices of this card), recording the mesh
    # kernels' arguments at these phases' shapes
    rec9 = Recorder(kern, list(MESH_KERNELS))
    try:
        phase9 = config4_phase(torch, dev, mesh, rehearsal)
        phase_done("9")
        # the mesh's fused forms on a seeded group of their own, outside
        # every phase's launch counts (config 4's traffic makes no fused
        # flush); their launches are kept under a tag of their own
        l0 = dict(kern.LAUNCHES)
        phase9["fused_forms"] = mesh_fused_check(torch, dk, psh, convert, dev,
                                                 mesh)
        phase9["fused_forms"]["launches"] = {
            k_: kern.LAUNCHES[k_] - l0[k_] for k_ in
            ("fused_deps_dense", "fused_attr_post")}
        check(rehearsal or all(phase9["fused_forms"]["launches"].values()),
              "phase9: the mesh's fused forms launched no K5 kernel "
              f"{phase9['fused_forms']['launches']}")
        for k_ in seen:
            seen[k_] += kern.LAUNCHES[k_] - l0[k_]
        phase10 = config5b_phase(torch, dk, psh, dev, mesh, rehearsal)
        phase_done("10")
        phase11 = graft_phase(torch, kern, drk, psh, dev, mesh, dense3,
                              NDD3, rehearsal)
        phase_done("11")
    finally:
        rec9.restore()
        sizes.restore()
    scatter_sizes = sizes.summary(kern.PACK_PARALLEL_BYTES)
    log("K3 calls on the main path: " + json.dumps(scatter_sizes))
    for tag, names in (("9", ("merge_blocks", "attr_tok", "deps_bucketed",
                              "attr_post", "deps_dense")),
                       ("10", ("calc_deps", "ts_max", "deps_dense")),
                       ("11", ("calc_deps", "ts_max", "sharded_frontier",
                               "sharded_drain_fix"))):
        for k_ in names:
            check(rehearsal or phase_launches[tag][k_] > 0,
                  f"phase{tag}: {k_} never launched {phase_launches[tag]}")
    launches = {k: sum(p[k] for p in phase_launches.values())
                for k in kern.KERNELS}
    for k in epilogues:
        launches[k] = sum(p[k] for p in phase_epilogues.values())
    log("launches by phase: " + json.dumps(phase_launches))
    if epilogues:
        log("fused epilogues by phase: " + json.dumps(phase_epilogues))
    if not rehearsal:
        missing = [k for k, v in launches.items()
                   if v == 0 and k not in MULTI_CARD_ONLY]
        check(not missing, f"kernels never launched on the main path: "
                           f"{missing}")

    # the dense frontier, checked and timed at the largest state the burn
    # gave it (the burn's in-flight sets stay below DENSE_MAX): repeated
    # calls on the recorded state and on a planned copy of it, and as the
    # tick pays for it, a new state each call, into a pinned buffer
    check("frontier_dense" in rec6.calls, "burn: no dense frontier sweep")
    a, kw, _w = rec6.calls["frontier_dense"]
    k4b_state = a[0]
    k4b_case = dense_frontier_case(torch, kern, drk, k4b_state)
    k4b_tick = dense_frontier_case(torch, kern, drk, k4b_state,
                                   tick=on_cuda)
    rows.update(run_checks(torch, {
        "frontier_dense": k4b_case,
        "frontier_dense[planned]": dense_frontier_case(
            torch, kern, drk, kern.checked_cols(k4b_state)),
        "frontier_dense[tick]": k4b_tick,
        "frontier_dense[tick planned]": dense_frontier_case(
            torch, kern, drk, k4b_state, tick=on_cuda and "planned")},
        "real", on_cuda, timed=True))
    for k in ("", "[planned]", "[tick]", "[tick planned]"):
        shapes["frontier_dense" + k] = list(k4b_state.adj.shape)
    k4b = {"planned": getattr(k4b_state, "_plan", None) is not None,
           "phase6_dense_ticks": ticks6.summary()}
    if on_cuda:
        # the short-call floor: an empty kernel through the same launch
        # path, timed the same way
        k4b["launch_floor_ms"] = time_ms(
            torch, lambda: launch_floor(kern, dev), on_cuda)
    log("K4b: " + json.dumps(k4b))
    # K6 dense at the burn's median fused group, repeated on the recorded
    # states and as the fused tick pays for it (new states each call,
    # into a pinned buffer, one sync; an earlier tree: .cpu()); and two
    # fused dense ticks in flight at once, each harvesting its own flags
    check("fused_frontier_dense" in med6.calls, "burn: no fused dense tick")
    a, _kw, _w, n_k6 = med6.median("fused_frontier_dense")
    k6_group = a[0]
    rows.update(run_checks(torch, {
        "fused_frontier_dense[burn median]": fused_frontier_case(
            torch, kern, drk, k6_group),
        "fused_frontier_dense[burn median tick]": fused_frontier_case(
            torch, kern, drk, k6_group, tick=on_cuda)}, "real", on_cuda,
        timed=True))
    k6_shape = [len(k6_group), max(st.status.shape[0] for st in k6_group)]
    shapes["fused_frontier_dense[burn median]"] = k6_shape
    shapes["fused_frontier_dense[burn median tick]"] = k6_shape
    tnode2 = TickNode()
    for sid, (st_, d_) in enumerate(tick_dense2 + tick_dense):
        st_.node, st_.store_id = tnode2, sid
    two_ticks = back_to_back_ticks(torch, kern, drk,
                                   [tick_dense2, tick_dense], on_cuda)
    log(f"burn: {n_k6} fused dense ticks, the median group "
        f"{[st.status.shape[0] for st in k6_group]}; two fused ticks in "
        f"flight, each its own flags: " + json.dumps(two_ticks))
    # K1a, K1b and K2 at the burn's median call (most of their launches
    # are the burn's small flushes), and K1b at the largest call of phase
    # 7's solo leg (config 5's fused-off flushes)
    dense_more = {}
    for name, case in (("deps_bucketed", bucket_case),
                       ("deps_dense", dense_case), ("attr_post", attr_case),
                       ("fused_deps_dense", fused_scan_case),
                       ("fused_attr_post", fused_attr_case)):
        if name in med6.calls:
            a, kw, _w, n_calls = med6.median(name)
            dense_more[name + "[burn median]"] = case(torch, kern, dk, *a,
                                                      **kw)
            shapes[name + "[burn median]"] = (
                list(a[2].shape) if name == "deps_bucketed" else
                list(a[1].shape) + [a[0].lo.shape[0]]
                if name == "deps_dense" else
                [len(a[0]), a[1].shape[1], max(t.lo.shape[0] for t in a[0])]
                if name == "fused_deps_dense" else list(a[5].shape)
                if name == "fused_attr_post" else [int(a[5].shape[0])])
            if name == "deps_bucketed":
                k1a_rows["burn median"] = bucket_row_stats(torch, dk, a, kw)
            log(f"burn: {n_calls} {name} calls, the median "
                f"{shapes[name + '[burn median]']}")
    # the burn's K5 calls: stores, rows, largest member and s, at the
    # median call (by stores x rows) and the largest of each
    k5_burn = {}
    if "fused_deps_dense" in med6.calls:
        calls = med6.calls["fused_deps_dense"]
        dims = {"stores": [len(c[0][0]) for c in calls],
                "rows": [c[0][1].shape[1] for c in calls],
                "n_max": [max(t.lo.shape[0] for t in c[0][0]) for c in calls],
                "s": [int(c[0][4]) for c in calls]}
        k5_burn = {"calls": len(calls),
                   **{k: {"p50": int(np.median(v)), "max": max(v)}
                      for k, v in dims.items()}}
        log("burn: K5 calls " + json.dumps(k5_burn))
    if "deps_dense" in rec7s.calls:
        a, kw, _w = rec7s.calls["deps_dense"]
        dense_more["deps_dense[phase7]"] = dense_case(torch, kern, dk, *a,
                                                      **kw)
        shapes["deps_dense[phase7]"] = list(a[1].shape) + [a[0].lo.shape[0]]
    rows.update(run_checks(torch, dense_more, "real", on_cuda, timed=True))
    # the mesh kernels at the largest shapes phases 9-11 gave them
    mesh_real = {}
    a, kw, _w = rec9.calls["calc_deps"]
    mesh_real["calc_deps"] = calc_case(torch, kern, dk, *a, **kw)
    shapes["calc_deps"] = [len(a[0]), a[1].msb.shape[0], a[0][0].capacity]
    a, kw, _w = rec9.calls["ts_max"]
    mesh_real["ts_max"] = ts_max_case(torch, kern, dk, *a, **kw)
    shapes["ts_max"] = list(a[0].shape)
    a, kw, _w = rec9.calls["merge_blocks"]
    mesh_real["merge_blocks"] = merge_case(torch, kern, psh, *a, **kw)
    shapes["merge_blocks"] = [len(a[0]), len(a[0][0]), a[2]]
    a, kw, _w = rec9.calls["sharded_frontier"]
    mesh_real["sharded_frontier"] = sweep_case(torch, kern, drk, psh, *a,
                                               **kw)
    shapes["sharded_frontier"] = [len(a[0]), a[2], a[3]]
    a, kw, _w = rec9.calls["sharded_drain_fix"]
    mesh_real["sharded_drain_fix"] = fixd_case(torch, kern, drk, psh, *a,
                                               **kw)
    shapes["sharded_drain_fix"] = [len(a[0]), a[2], a[3]]
    # the per-sweep drain (a mesh across cards) on phase 11's chain: its
    # first sweep
    a = sweep_args(torch, psh, mesh, dense3, True)
    mesh_real["sharded_drain"] = sweep_case(torch, kern, drk, psh, *a)
    shapes["sharded_drain"] = [len(a[0]), a[2], a[3]]
    a, kw, _w = rec9.calls["attr_tok"]
    mesh_real["attr_tok"] = tok_case(torch, kern, psh, *a, **kw)
    shapes["attr_tok"] = [len(a[0]), a[0][0].shape[0]]
    rows.update(run_checks(torch, mesh_real, "real", on_cuda, timed=True))
    # the per-sweep loop that sharded_drain takes for a mesh across cards
    # (a check, after the main path), on phase 11's chain against K8
    before = kern.LAUNCHES["sharded_drain"]
    if on_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    applied, newly = psh.drain_by_sweeps(mesh, dense3)
    want = kern.drain_fix_dense(dense3)
    check(bool(torch.equal(applied, want[0]))
          and bool(torch.equal(newly, want[1])),
          "drain_by_sweeps != drain_fix_dense (K8) on the chain")
    phase11["drain_by_sweeps"] = {
        "ms": (time.perf_counter() - t0) * 1e3,
        "launches": kern.LAUNCHES["sharded_drain"] - before,
        "applied": int(applied.sum())}
    log("drain_by_sweeps on the chain: equal to K8, "
        + json.dumps(phase11["drain_by_sweeps"]))

    # a real CUDA error in a store's flush, after the main path: its fault
    # and quarantine are its own (every phase above counted none)
    fault_check = real_error_check(torch, kern, dev, rehearsal)

    # the device operations one call makes and their device time: K12 at
    # phase 9's recorded shape, K3's timed form and its live form at the
    # largest recorded call and at P = 8, and the library calls they are
    # timed against
    call_ops = {}
    if on_cuda:
        for name, case in (("merge_blocks", mesh_real["merge_blocks"]),
                           ("scatter_rows", real["scatter_rows"]),
                           ("scatter_rows[live]",
                            real["scatter_rows[live]"]),
                           ("scatter_rows[live P8]",
                            real["scatter_rows[live P8]"])):
            call_ops[name] = device_ops(torch, case[0])
            call_ops[name + " library"] = device_ops(torch, case[2])
        # K1a, K1b and K2 at the largest recorded call and the burn's
        # median, K8 on the chain and the wide input: the device's share of
        # each call's time
        for name in ("deps_bucketed", "deps_dense", "attr_post",
                     "fused_deps_dense", "fused_attr_post"):
            takes = 3 if name.startswith("fused_") else 1
            call_ops[name] = device_ops(torch, real[name][0], takes)
            if name + "[burn median]" in dense_more:
                call_ops[name + "[burn median]"] = device_ops(
                    torch, dense_more[name + "[burn median]"][0], takes)
        for name in ("drain_fix_dense", "drain_fix_dense[wide]",
                     "drain_fix_dense[narrow then wide]",
                     "frontier_dense[4096]"):
            call_ops[name] = device_ops(torch, real[name][0])
        # K4b at the burn's call, repeated and as the tick pays for it,
        # and the empty kernel of its floor; K11 (its fold words zeroed
        # before) and its cross-slice reduce at the recorded calls
        call_ops["frontier_dense"] = device_ops(torch, k4b_case[0])
        call_ops["frontier_dense[tick]"] = device_ops(torch, k4b_tick[0])
        # K4a at phase 5's state and K6 ELL at phase 7's pair, repeated and
        # as the ticks pay for them: the most of three traces
        for name in ("frontier_ell", "frontier_ell[tick]",
                     "fused_frontier_ell", "fused_frontier_ell[tick]"):
            call_ops[name] = device_ops(torch, real[name][0], takes=3)
        call_ops["launch floor"] = device_ops(
            torch, lambda: launch_floor(kern, dev))
        # K6 dense (the phase 3 pair, planned, the burn's median group
        # repeated and in the tick's form) and K7 dense (the chain in the
        # first CTA, past its rows on the grid)
        for name in ("fused_frontier_dense", "fused_frontier_dense[planned]",
                     "fused_frontier_dense[burn median]",
                     "fused_frontier_dense[burn median tick]", "level_dense",
                     "level_dense[chain8192]", "level_dense[n512]",
                     "level_dense[n64]", "level_ell",
                     "level_ell[all stable 131072]", "level_ell[phase8 100k]",
                     "level_ell[phase8 chain]", "level_ell[chain1024]",
                     "level_ell[n512]", *drain_inputs):
            if name in rows:
                case = (real.get(name)
                        or fused_frontier_case(torch, kern, drk, k6_group,
                                               tick=name.endswith("tick]")))
                call_ops[name] = device_ops(torch, case[0], takes=3)
        call_ops["attr_tok"] = device_ops(torch, mesh_real["attr_tok"][0],
                                          takes=3)
        call_ops["calc_deps"] = device_ops(torch, mesh_real["calc_deps"][0])
        call_ops["ts_max"] = device_ops(torch, mesh_real["ts_max"][0])
        # K8 ELL and K13's one-launch drain: the most of three traces
        for name in ("drain_fix_ell", "drain_fix_ell[narrow then wide]"):
            call_ops[name] = device_ops(torch, real[name][0], takes=3)
        call_ops["sharded_drain_fix"] = device_ops(
            torch, mesh_real["sharded_drain_fix"][0], takes=3)
        # K10 at config 3's chain and the probe's
        for name in ("dense_to_ell", "dense_to_ell[probe 256 d=4]"):
            call_ops[name] = device_ops(torch, real[name][0], takes=3)
        log("device operations per call: " + json.dumps(call_ops))
        # K9's epilogue: the fused call's device time against the
        # levels-only launch on the same input
        epi = {tag: {"fused_us": call_ops[f][
                         "device_us"], "levels_only_us": call_ops[lo][
                         "device_us"]}
               for tag, f, lo in (
                   ("phase8 100k (grid)", "level_drain",
                    "level_ell[phase8 100k]"),
                   ("phase8 chain (first CTA)", "level_drain[phase8 chain]",
                    "level_ell[phase8 chain]"),
                   ("config3 chain dense (first CTA)",
                    "level_drain[config3 chain dense]", "level_dense"),
                   ("chain8192 dense (grid)", "level_drain[chain8192 dense]",
                    "level_dense[chain8192]"),
                   ("n512 ELL (first CTA)", "level_drain[n512]",
                    "level_ell[n512]"))}
        for v in epi.values():
            v["epilogue_us"] = v["fused_us"] - v["levels_only_us"]
        log("K9 epilogue, device us (fused call against the levels-only "
            "launch, the most of three traces): " + json.dumps(epi))
        for name, ops_ in call_ops.items():
            if name.startswith("attr_post"):
                check(ops_["kernels"] == 1 and ops_["copies"] == 0
                      and ops_["memsets"] == 0,
                      f"K2 {name}: not one kernel and no copy a call {ops_}")
            if name.startswith("deps_dense"):
                check(ops_["kernels"] == 1 and ops_["memsets"] == 0,
                      f"K1b {name}: not one kernel and no memset {ops_}")
            if name.startswith(("deps_bucketed", "drain_fix",
                                "sharded_drain_fix", "frontier_dense",
                                "ts_max", "calc_deps", "level_ell",
                                "level_dense", "dense_to_ell")) or (
                    name == "frontier_ell") or (
                    name.startswith(("frontier_ell", "fused_frontier_ell"))
                    and ell_out(kern)) or (
                    name.startswith("fused_frontier_dense")
                    and k6_by_value(kern)) or (
                    name.startswith("level_drain") and fused_k9(kern)):
                check(ops_["kernels"] == 1 and ops_["copies"] == 0
                      and ops_["memsets"] == 0,
                      f"{name}: not one kernel and no copy a call {ops_}")
            if name == "attr_tok" and hasattr(kern, "TOK_MAX_REFS"):
                check(ops_["kernels"] == 1 and ops_["copies"] == 0
                      and ops_["memsets"] == 0,
                      f"attr_tok: not one kernel and no copy a call {ops_}")
            if name.startswith(("fused_deps_dense", "fused_attr_post")):
                want = ("fused_csr" if name.startswith("fused_deps_dense")
                        else "fused_attr")
                check(ops_["kernels"] == 1 and ops_["copies"] == 0
                      and ops_["memsets"] == 0 and want in ops_["names"][0],
                      f"K5 {name}: not one {want} kernel and no copy a "
                      f"call {ops_}")
        k12, k3, k3s = (call_ops["merge_blocks"],
                        call_ops["scatter_rows[live]"],
                        call_ops["scatter_rows[live P8]"])
        check(k12["kernels"] == 1 and k12["copies"] == 0
              and k12["memsets"] == 0,
              f"K12: not one kernel and no copy a call {k12}")
        check(all(x["kernels"] == 1 and x["copies"] == 1
                  and x["memsets"] == 0 for x in (k3, k3s)),
              f"K3 live: not one copy and one kernel a call {k3} {k3s}")

    # one whole fused flush at phase 7's recorded call: the K5 pair with
    # device tensors in, and as the dispatcher makes it, its query
    # matrices and rank bounds uploaded from the host first by a pageable
    # copy each (``device_index._upload``, which waits on the stream) and,
    # to compare, by one asynchronous copy from pinned memory
    # (``pinned_upload``); each on an idle stream and behind 0.1 ms of
    # queued work, where the host's enqueue time shows whether it waits
    from accord_tpu_torch.local import device_index as dix
    a7, kw7, _w = rec7f.calls["fused_flat_attr"]
    q7, r7 = a7[3].cpu().numpy(), a7[4].cpu().numpy()

    def flush_dev():
        return dk.fused_flat_attr(*a7, **kw7)

    def flush_pinned():
        q, r = pinned_upload(torch, (q7, r7), dev)
        return dk.fused_flat_attr(*a7[:3], q, r, *a7[5:], **kw7)

    def flush_pageable():
        return dk.fused_flat_attr(*a7[:3], dix._upload(q7, dev),
                                  dix._upload(r7, dev), *a7[5:], **kw7)
    for fn in (flush_pinned, flush_pageable):
        check(_max_abs_err(torch, fn(), flush_dev()) == 0,
              "phase7's recorded flush: uploaded inputs give other bytes")
    k5_flush = {"shape": [len(a7[0])] + list(a7[3].shape[1:]),
                "busy_cycles": FLUSH_BUSY_CYCLES}
    for tag, fn in (("device inputs", flush_dev),
                    ("host inputs, pageable", flush_pageable),
                    ("host inputs, pinned", flush_pinned)):
        k5_flush[tag] = fused_flush_timing(torch, fn, on_cuda)
        if on_cuda:
            k5_flush[tag]["behind queued work"] = fused_flush_timing(
                torch, fn, on_cuda, busy=FLUSH_BUSY_CYCLES)
            k5_flush[tag]["ops"] = device_ops(torch, fn, takes=3)
    if on_cuda:
        for tag, copies in (("device inputs", 0),
                            ("host inputs, pageable", 2),
                            ("host inputs, pinned", 1)):
            ops_ = k5_flush[tag]["ops"]
            kn = ops_["names"]
            check(ops_["kernels"] == 2 and ops_["copies"] == copies
                  and ops_["memsets"] == 0
                  and sum("fused_csr" in x for x in kn) == 1
                  and sum("fused_attr" in x for x in kn) == 1,
                  f"K5 whole flush, {tag}: not {copies} copies and the two "
                  f"K5 kernels {ops_}")
    log("K5 whole flush at phase 7's recorded call: " + json.dumps(k5_flush))
    # the latency floors of a sweep: one grid barrier of the fixpoint's
    # grid (the earlier design's: a warp a row, 256-thread CTAs; the
    # frontier design's: every resident 1,024-thread CTA), one block
    # barrier with a shared-memory round trip (a level of lists in shared
    # memory), and two dependent L2 reads with a block barrier (a level of
    # K8 ELL's lists in global memory); a drain's floor is its sweeps x
    # its level's
    sync_floor = {}
    if on_cuda:
        n3 = dense3.status.shape[0]
        sync_floor = {
            "grid_warp_a_row": sync_probe_us(torch, 0, -(-n3 * 32 // 256),
                                             256),
            "grid_resident_1024": sync_probe_us(torch, 0, 1 << 20, 1024),
            "block_256": sync_probe_us(torch, 1, 1, 256),
            "block_1024": sync_probe_us(torch, 1, 1, 1024),
            "two_l2_reads_block_256": sync_probe_us(torch, 2, 1, 256)}
        log("sweep latency floors [us a step]: " + json.dumps(sync_floor))
        blk, l2 = (sync_floor[k]["us"] for k in ("block_256",
                                                 "two_l2_reads_block_256"))
        sync_floor["drain_floor_ms"] = {
            "drain_fix_dense chain": fix_sweeps["chain"] * blk * 1e-3,
            "sharded_drain_fix chain": fix_sweeps["chain"] * blk * 1e-3,
            "drain_fix_ell 100k": fix_sweeps["ell_100k"] * l2 * 1e-3,
            "drain_fix_ell 100k, barriers only":
                fix_sweeps["ell_100k"] * blk * 1e-3,
            # K7 dense on the chain: one read of its adjacency, then two
            # barriers of the first CTA (1,024 threads) a round
            "level_dense chain": (
                cstate.adj.numel() / HBM_BPS * 1e3
                + level_rounds["dense_chain"] * 2
                * sync_floor["block_1024"]["us"] * 1e-3)}
        log("drain latency floors [ms]: "
            + json.dumps(sync_floor["drain_floor_ms"]))

    profiles = {}
    if on_cuda:
        def two_batches():
            handles = [(ds.deps_query_batch_begin(b, prune_floors=True,
                                                  attributed=True), b)
                       for b in batches[:2]]
            for h, b in handles:
                ds.deps_query_batch_end_attributed(
                    safe, h, [P.DepsBuilder() for _ in b])

        profiles["phase4"] = profile_window(torch, "phase4_x2_batches",
                                            two_batches)
        # phase 7's cell, four rounds each way: where a round's time goes
        for mode, fusion in (("solo", False), ("fused", True)):
            disp.fusion = fusion
            profiles["phase7_" + mode] = profile_window(
                torch, f"phase7_{mode}_x4_rounds",
                lambda: drive_flushes(fnode, fdevs, 4, KEYS5, seed=11))

    table = []
    for name, (src, repl) in KMETA.items():
        row = rows[name]
        if name == "level_drain" and not fused_k9(kern):
            src = "accord_tpu_torch/ops/csrc/logsq.cu"
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": repl, "launches": launches[name],
                      "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                      "plain_ms": row["plain_ms"],
                      "bound_ms": row["bound_ms"],
                      "bound_by": row["bound_by"],
                      "library_ms": row["library_ms"],
                      "card": env["nvidia_smi"]})
        if name in epilogues:
            # its launches are the calls that ran it inside K7's launch
            table[-1]["fused_into"] = ["level_ell", "level_dense"]
    detail = {name: {"shape": shapes[name], "bytes": rows[name]["bytes"],
                     "ops": rows[name]["ops"]} for name in KMETA}
    sq3 = int(drk.drain_dense_logsq_plain(dense3)[2])
    n3 = dense3.status.shape[0]
    k9 = detail["logsq_dense"]
    k9["dense_bound_ms"] = sq3 * 2 * n3 ** 3 / TENSOR_INT8_OPS * 1e3
    k9["earlier_simt_bound_ms"] = logsq_simt_ms(n3, sq3)
    k9["dense_input"] = {key: rows["logsq_dense[dense input]"][key]
                         for key in ("ms", "bound_ms", "library_ms", "ops")}
    log(f"K9 at config 3's chain: {sq3} squarings, "
        f"{rows['logsq_dense']['ms']:.4f} ms against the bound of the "
        f"tile pairs its data needs {rows['logsq_dense']['bound_ms']:.4f} "
        f"ms (dense squarings: {k9['dense_bound_ms']:.4f}; the earlier "
        f"SIMT design's: {k9['earlier_simt_bound_ms']:.4f}); on a dense "
        f"input {k9['dense_input']['ms']:.4f} ms against its dense bound "
        f"{k9['dense_input']['bound_ms']:.4f}")
    summary = {"env": env, "kernels": table, "kernel_shapes": detail,
               "phase_launches": phase_launches,
               "phase4_queries_per_s": nq / dt, "phase4_breakdown": breakdown,
               "phase4_steps_s": spent,
               "phase5_chain_ticks": {"ell_among_100k": chain_at,
                                      "dense_alone": chain_c,
                                      "depth": NDD},
               "phase6_fused": {k: r1.stats.get(k) for k in (
                   "device_fused_launches", "device_fused_tick_launches")},
               "phase6_counters": c1,
               "phase7": fused7, "phase7_launches_per_fused_flush": per_flush,
               "level_rounds": level_rounds, "profiles": profiles,
               "phase8": phase8, "phase9": phase9, "phase10": phase10,
               "phase11": phase11, "phase_seconds": phase_seconds,
               "scatter_live": {k: rows[k] for k in (
                   "scatter_rows[live]", "scatter_rows[live P8]")},
               "real_error_check": fault_check,
               "scatter_sizes": scatter_sizes, "pack_timings": pack_t,
               "device_ops_per_call": call_ops,
               "recorded_calls_more": {k: dict(rows[k], shape=shapes[k])
                                       for k in dense_more},
               "k1a_rows": k1a_rows, "k8_sweeps": fix_sweeps,
               "k8_more": {k: dict(rows[k], shape=shapes[k]) for k in (
                   "drain_fix_dense[wide]",
                   "drain_fix_dense[narrow then wide]",
                   "drain_fix_ell[narrow then wide]")},
               "sync_floor_us": sync_floor, "k5_flush": k5_flush,
               "k5_burn": k5_burn, "k4b": k4b,
               "k4b_more": {k: dict(rows[k], shape=shapes.get(k)) for k in (
                   "frontier_dense[4096]", "frontier_dense[planned]",
                   "frontier_dense[tick]", "frontier_dense[tick planned]")},
               "k4a_k6_ell": {k: dict(rows[k], shape=shapes.get(k))
                              for k in rows if k.startswith((
                                  "frontier_ell", "fused_frontier_ell"))},
               "k6_k7_more": {k: dict(rows[k], shape=shapes.get(k))
                              for k in rows if k.startswith((
                                  "fused_frontier_dense[",
                                  "level_dense[", "level_ell["))},
               "k7_ell_forms": k7_ell_forms, "k7_ell_calls": k7_ell_calls,
               "k6_two_ticks": two_ticks,
               "seconds": time.perf_counter() - t_start}
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    if rehearsal:
        log("rehearsal: control flow ok on the CPU (no result line)")
        return 3
    log(json.dumps({"kernels": table}))
    log(env["nvidia_smi"])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
