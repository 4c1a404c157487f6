"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object file, and the objects are
linked into one shared library with a plain C interface,
``build/accord_tpu_torch/libaccord_kernels.so`` under the repository root.
The library is loaded with ``ctypes``.  The build runs at first use and is
keyed on a hash of the sources and flags, so an unchanged checkout reuses
the library and an edited source rebuilds it.  A failed build raises with
nvcc's output; nothing falls back to the plain PyTorch versions.

The build log kept in ``build_log()`` carries ptxas's report (registers,
shared memory and spills per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "accord_tpu_torch"
LIB_NAME = "libaccord_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# what a launch takes by value in its kernel parameter: K12's blocks, K3's
# columns, K13's and K11's slices, K5's member stores, K2 attr_tok's
# pointers (every slice's lo, then as many rows' entries as fit).  nvcc
# gets them as macros, so that a kernel and its wrapper in ops.kernels read
# one number.
# K6 takes up to ACCORD_FUSED_MAX_STORES members too (72 bytes each dense,
# 80 ELL).
# K5's members are 104 bytes each in the scan and 192 in the attribution,
# so 128 of them fill most of the 32,764 bytes a kernel parameter may hold
# (CUDA 12.1 and later)
LIMITS = {"ACCORD_MERGE_MAX_REFS": 128, "ACCORD_SCATTER_MAX_COLS": 16,
          "ACCORD_SHARDED_MAX_SLICES": 16, "ACCORD_FUSED_MAX_STORES": 128,
          "ACCORD_TOK_MAX_REFS": 64}
# launch geometry that the CPU tests' model of a kernel's decomposition
# follows: K1b's and K5's threads a scan CTA, in which phase 2 walks a
# row's mask words; the largest level of the frontier drain that its first
# CTA takes alone, for the tile loader (K8 dense, K13) and the edge loader
# (K8 ELL, in level entries), and the dependents in an item of the edge
# loader's levels; the 32-entry words of a K5 attribution chunk; the rows
# (a thread each) of a K4a / K6 ELL frontier CTA and the edges a row
# gathers at once
GEOMETRY = {"ACCORD_DEPS_THREADS": 256, "ACCORD_DRAIN_HANDOVER": 128,
            "ACCORD_DRAIN_HANDOVER_ELL": 512, "ACCORD_DRAIN_ELL_ITEM": 12,
            "ACCORD_FUSED_CHUNK_WORDS": 32, "ACCORD_FRONTIER_ELL_ROWS": 256,
            "ACCORD_FRONTIER_ELL_CHUNK": 4}
DEFINES = [f"-D{k}={v}" for k, v in {**LIMITS, **GEOMETRY}.items()]
ENTRY_POINTS = ("accord_deps_bucketed", "accord_deps_dense",
                "accord_attr_post", "accord_scatter_rows",
                "accord_frontier_ell", "accord_frontier_dense",
                "accord_fused_deps_dense", "accord_fused_attr_post",
                "accord_fused_frontier_ell", "accord_fused_frontier_dense",
                "accord_level_ell", "accord_level_dense",
                "accord_drain_fix_dense", "accord_drain_fix_ell",
                "accord_logsq_dense",
                "accord_dense_degree", "accord_dense_to_ell",
                "accord_calc_deps", "accord_ts_max", "accord_merge_blocks",
                "accord_sharded_sweep", "accord_sharded_drain_fix",
                "accord_attr_tok", "accord_empty_probe")

_LOCK = threading.Lock()
_LIB = None
_ENTRIES = {}
_LOG = {"seconds": None, "stderr": "", "cached": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS + DEFINES).encode())
    for f in sorted(CSRC.glob("*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> Path:
    """nvcc per source in parallel, then one link; returns the library."""
    flags = ARCH + FLAGS + DEFINES
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    lib = out_dir / LIB_NAME
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", *[str(o) for _s, o, _p in procs], "-o",
         str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    logs.append(f"== link\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
    _LOG["stderr"] = "\n".join(logs)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        want = source_hash()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / "source.hash"
        t0 = time.perf_counter()
        cached = (lib_path.exists() and stamp.exists()
                  and stamp.read_text().strip() == want)
        if not cached:
            nvcc = _nvcc()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                built = _compile(nvcc, Path(tmp))
                os.replace(built, lib_path)
            stamp.write_text(want + "\n")
        _LOG["seconds"] = time.perf_counter() - t0
        _LOG["cached"] = cached
        lib = ctypes.CDLL(str(lib_path))
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _ENTRIES[name[len("accord_"):]] = fn
        lib.accord_error_string.argtypes = [ctypes.c_int]
        lib.accord_error_string.restype = ctypes.c_char_p
        lib.accord_merge_workspace_words.argtypes = [ctypes.c_int64] * 4
        lib.accord_merge_workspace_words.restype = ctypes.c_int64
        lib.accord_bucketed_workspace_words.argtypes = [ctypes.c_int64] * 4
        lib.accord_bucketed_workspace_words.restype = ctypes.c_int64
        lib.accord_dense_workspace_words.argtypes = [ctypes.c_int64] * 2
        lib.accord_dense_workspace_words.restype = ctypes.c_int64
        lib.accord_attr_workspace_words.argtypes = [ctypes.c_int64]
        lib.accord_attr_workspace_words.restype = ctypes.c_int64
        lib.accord_fused_scan_workspace_words.argtypes = [ctypes.c_int64] * 3
        lib.accord_fused_scan_workspace_words.restype = ctypes.c_int64
        lib.accord_fused_attr_workspace_words.argtypes = [ctypes.c_int64] * 2
        lib.accord_fused_attr_workspace_words.restype = ctypes.c_int64
        lib.accord_drain_fix_workspace_words.argtypes = [ctypes.c_int64]
        lib.accord_drain_fix_workspace_words.restype = ctypes.c_int64
        lib.accord_drain_fix_ell_workspace_words.argtypes = [ctypes.c_int64] * 2
        lib.accord_drain_fix_ell_workspace_words.restype = ctypes.c_int64
        lib.accord_level_ell_workspace_words.argtypes = [ctypes.c_int64] * 2
        lib.accord_level_ell_workspace_words.restype = ctypes.c_int64
        lib.accord_level_dense_workspace_words.argtypes = [ctypes.c_int64]
        lib.accord_level_dense_workspace_words.restype = ctypes.c_int64
        lib.accord_calc_tiles.argtypes = [ctypes.c_int64]
        lib.accord_calc_tiles.restype = ctypes.c_int64
        _LIB = lib
        return lib


def entries() -> dict:
    """Every entry point of the loaded library by its short name
    ("scatter_rows" for ``accord_scatter_rows``), resolved once at load."""
    if _LIB is None:
        library()
    return _ENTRIES


def build_log() -> dict:
    """{"seconds", "cached", "stderr"} of the build (or load) that ran."""
    return dict(_LOG)
