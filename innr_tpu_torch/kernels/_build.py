"""Build the CUDA sources of this package with nvcc and load them by ctypes.

Every ``innr_tpu_torch/csrc/*.cu`` is compiled into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). The
sources compile in parallel, one nvcc each, and are then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

The library goes to ``build/innr_tpu_torch/`` beside the package, named by
a hash of the sources (``*.cu`` and ``*.cuh``) and flags, so a first use
builds it and a changed source rebuilds it. ``-Xptxas -v``'s report
(registers, shared memory, spills per kernel) is kept beside the library
as ``<lib>.log``.

Building and loading hold one process-wide lock: the first kernel calls of
two threads (a :class:`~innr_tpu_torch.serving.MicroBatcher`'s flush
workers) would otherwise run nvcc on the same outputs at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "innr_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: ctypes.CDLL | None = None
_LOCK = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "innr_tpu_torch: nvcc (the CUDA compiler) was not found on PATH or "
        "at /usr/local/cuda/bin/nvcc; the CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile the sources if no library for their hash exists; return its
    path. Raises if nvcc is missing or the compile fails."""
    with _LOCK:
        return _build()


def _build() -> Path:
    nvcc = _nvcc()
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib = BUILD_DIR / f"libinnr_tpu_torch_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, proc, out in zip(cmds, procs, outs):
            _check(cmd, proc.returncode, out)
        proc = subprocess.run(link, capture_output=True, text=True)
        _check(link, proc.returncode, proc.stdout + proc.stderr)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    Path(f"{lib}.log").write_text("".join(outs))
    os.replace(tmp, lib)
    return lib


def _check(cmd: list[str], returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"innr_tpu_torch: nvcc failed ({returncode}):\n{' '.join(cmd)}\n{output}"
        )


def build_log() -> str:
    """The compiler's report for the current sources ('' if not built here)."""
    log = Path(f"{build()}.log")
    return log.read_text() if log.is_file() else ""


def load() -> ctypes.CDLL:
    """The built library with every entry point's argument types declared."""
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _declare(ctypes.CDLL(str(build())))
    return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    """Declare every entry point's argument and result types, then
    publish the library."""
    global _LIB
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    lib.innr_knn_scan.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, f32, f32, ptr, ptr, ptr, i32, i64, i32, i32,
        i32, i32, i32, ptr,
    ]
    lib.innr_knn_scan.restype = i32
    lib.innr_knn_grid.argtypes = [i32, i32, i32, i32, i32, ptr]
    lib.innr_knn_grid.restype = i32
    lib.innr_knn_merge.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.innr_knn_merge.restype = i32
    lib.innr_knn_scan_tiles.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, f32, f32, ptr, ptr, ptr, ptr, ptr, i32, i64,
        i32, i32, i32, i64, i64, i32, ptr,
    ]
    lib.innr_knn_scan_tiles.restype = i32
    lib.innr_threshold_scan.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr, ptr, i64, i32, i64, i32, i32, ptr,
    ]
    lib.innr_threshold_scan.restype = i32
    lib.innr_threshold_compact.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr, ptr, f32, ptr, i64, i32, i64, i32, i32, ptr,
    ]
    lib.innr_threshold_compact.restype = i32
    lib.innr_threshold_plan.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, f32, ptr, ptr, ptr,
                                        ptr]
    lib.innr_threshold_plan.restype = i32
    lib.innr_threshold_header_words.argtypes = [i64, i32]
    lib.innr_threshold_header_words.restype = i64
    lib.innr_threshold_count.argtypes = [ptr, ptr, ptr]
    lib.innr_threshold_count.restype = i32
    lib.innr_threshold_copy.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr]
    lib.innr_threshold_copy.restype = i32
    lib.innr_nearest_centroid.argtypes = [
        ptr, i32, ptr, ptr, ctypes.c_float, ptr, ptr, i64, i32, i32, ptr,
    ]
    lib.innr_nearest_centroid.restype = i32
    lib.innr_packed_scan.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, i32, i32,
        ptr,
    ]
    lib.innr_packed_scan.restype = i32
    lib.innr_packed_grid.argtypes = [i32, i32, i32, i32, i32, ptr]
    lib.innr_packed_grid.restype = i32
    lib.innr_packed_rows.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i64, i32, ptr]
    lib.innr_packed_rows.restype = i32
    lib.innr_slot_scan.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, i32, ptr,
    ]
    lib.innr_slot_scan.restype = i32
    lib.innr_slot_smem_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.innr_slot_smem_bytes.restype = i64
    lib.innr_sparse_scan.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr, i32, i64, i32, i32, i32, i32, i32, i32, ptr,
    ]
    lib.innr_sparse_scan.restype = i32
    lib.innr_sparse_table_bytes.argtypes = [i32, i32, i32]
    lib.innr_sparse_table_bytes.restype = i64
    lib.innr_maxsim_scores.argtypes = [
        ptr, ptr, ptr, ptr, f32, ptr, ptr, i32, i32, i32, i32, i64, i32, i32, i32, i32, i32,
        i32, i32, ptr,
    ]
    lib.innr_maxsim_scores.restype = i32
    lib.innr_maxsim_scores_bf16.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, i32, i32, i32, i32, ptr,
    ]
    lib.innr_maxsim_scores_bf16.restype = i32
    _LIB = lib
