"""ctypes loader for the native host runtime (``native/innr_host.c``).

The counterpart of :mod:`innr_tpu._native`: the host side of ingest (the
data-loader encoders of :mod:`innr_tpu_torch.loader`) and the streaming
:class:`~innr_tpu_torch.ops.topk.TopK` merge, in C. This is host code, not
a kernel. The library is built with ``cc`` at first use into
``build/innr_tpu_torch/`` beside the package (the CUDA library's
directory), checked for ABI version 3, and rebuilt when it is stale or
corrupt. Without ``cc`` (or the source) every wrapper returns ``None`` and
its caller takes its numpy path, which gives the same bits.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from innr_tpu_torch.kernels._build import BUILD_DIR

ABI_VERSION = 3
_SRC = Path(__file__).resolve().parent.parent / "native" / "innr_host.c"
_LIB_DIR = BUILD_DIR
_LIB_NAME = "libinnr_host.so"
_CFLAGS = ("-O3", "-std=c99", "-shared", "-fPIC", "-pthread")

_lib = None
_LOCK = threading.Lock()


def _lib_path() -> Path:
    return _LIB_DIR / _LIB_NAME


def _compile() -> Path | None:
    """Compile the source to a fresh file name beside the library; None
    when ``cc`` or the source is missing or the compile fails."""
    if not _SRC.exists():
        return None
    tmp = _lib_path().with_suffix(f".{os.getpid()}.{threading.get_ident()}.so")
    try:
        _LIB_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["cc", *_CFLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
        return tmp
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def _open(path: Path):
    """The library at ``path`` if it loads and reports our ABI, else None."""
    try:
        lib = ctypes.CDLL(str(path))
        lib.innr_native_abi_version.restype = ctypes.c_int32
        return lib if lib.innr_native_abi_version() == ABI_VERSION else None
    except (OSError, AttributeError):
        return None


def _load():
    """The declared library, building or rebuilding it as needed; None when
    it cannot be had."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        path = _lib_path()
        lib = _open(path) if path.exists() else None
        if lib is None:
            # Missing, stale (an older ABI) or corrupt (an interrupted
            # build): build it anew. dlopen hands back a handle it already
            # holds for a path, so the new library is opened under its
            # fresh name first, then moved into place.
            fresh = _compile()
            if fresh is None:
                return None
            lib = _open(fresh)
            os.replace(fresh, path)
            if lib is None:
                return None
        _declare(lib)
        _lib = lib
        return lib


def _declare(lib) -> None:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    lib.innr_topk_insert_batch.argtypes = [f32p, u32p, i64, i32, f32p, u32p, i32p]
    lib.innr_pack_binary_rows_mt.argtypes = [f32p, i64, i64, f32, u32p, i32]
    lib.innr_pack_ternary_rows_mt.argtypes = [f32p, i64, i64, f32, u32p, u32p, i32]
    lib.innr_quantize_u8_rows_mt.argtypes = [f32p, i64, i64, f32, f32, u8p, i32]
    lib.innr_minhash_rows_mt.argtypes = [u64p, i64p, i64, i32, u32p, i32]
    lib.innr_pack_ternary.argtypes = [f32p, i64, f32, u32p, u32p]
    lib.innr_hamming_scan.argtypes = [u32p, u32p, i64, i64, u32p]
    for fn in (lib.innr_topk_insert_batch, lib.innr_pack_binary_rows_mt,
               lib.innr_pack_ternary_rows_mt, lib.innr_quantize_u8_rows_mt,
               lib.innr_minhash_rows_mt, lib.innr_pack_ternary, lib.innr_hamming_scan):
        fn.restype = None


def available() -> bool:
    """True when the native host library is loaded (or buildable)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _n_threads(r: int) -> int:
    """Encoder threads: several only when the rows pay for them (the
    results are the same bits at any thread count)."""
    if r < 16_384:
        return 1
    return min(os.cpu_count() or 1, 16)


# -- wrappers (None when the library is unavailable) -------------------------

def topk_insert_batch(dists, ids, k, buf_d, buf_i, count) -> int | None:
    """Stream (ids, dists) into the running (buf_d, buf_i, count) tracker;
    returns the new count."""
    lib = _load()
    if lib is None:
        return None
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    c = ctypes.c_int32(count)
    lib.innr_topk_insert_batch(_ptr(dists, ctypes.c_float), _ptr(ids, ctypes.c_uint32),
                               dists.size, k, _ptr(buf_d, ctypes.c_float),
                               _ptr(buf_i, ctypes.c_uint32), ctypes.byref(c))
    return int(c.value)


def pack_binary_rows(rows: np.ndarray, threshold: float) -> np.ndarray | None:
    """(R, D) float32 rows -> (R, ceil(D/32)) uint32 words."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    r, d = rows.shape
    out = np.zeros((r, (d + 31) // 32), dtype=np.uint32)
    lib.innr_pack_binary_rows_mt(_ptr(rows, ctypes.c_float), r, d, threshold,
                                 _ptr(out, ctypes.c_uint32), _n_threads(r))
    return out


def pack_ternary_rows(rows: np.ndarray, threshold: float):
    """(R, D) float32 rows -> ((R, W) pos, (R, W) neg) uint32 bitplanes."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    r, d = rows.shape
    w = (d + 31) // 32
    pos = np.zeros((r, w), dtype=np.uint32)
    neg = np.zeros((r, w), dtype=np.uint32)
    lib.innr_pack_ternary_rows_mt(_ptr(rows, ctypes.c_float), r, d, threshold,
                                  _ptr(pos, ctypes.c_uint32), _ptr(neg, ctypes.c_uint32),
                                  _n_threads(r))
    return pos, neg


def pack_ternary(v: np.ndarray, threshold: float):
    """One (D,) float32 vector -> ((W,) pos, (W,) neg) uint32 bitplanes."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(v, dtype=np.float32)
    w = (v.size + 31) // 32
    pos = np.zeros(w, dtype=np.uint32)
    neg = np.zeros(w, dtype=np.uint32)
    lib.innr_pack_ternary(_ptr(v, ctypes.c_float), v.size, threshold,
                          _ptr(pos, ctypes.c_uint32), _ptr(neg, ctypes.c_uint32))
    return pos, neg


def quantize_u8_rows(rows: np.ndarray, alpha: float, offset: float) -> np.ndarray | None:
    """(R, D) float32 rows -> (R, D) uint8 codes. The C encoder rounds
    ``255 / alpha`` in float32 from a float32 ``alpha``."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    r, d = rows.shape
    out = np.zeros((r, d), dtype=np.uint8)
    lib.innr_quantize_u8_rows_mt(_ptr(rows, ctypes.c_float), r, d, alpha, offset,
                                 _ptr(out, ctypes.c_uint8), _n_threads(r))
    return out


def hamming_scan(query: np.ndarray, corpus: np.ndarray) -> np.ndarray | None:
    """Hamming distances of a (W,) uint32 query to each row of an (N, W)
    uint32 corpus -> (N,) uint32."""
    lib = _load()
    if lib is None:
        return None
    query = np.ascontiguousarray(query, dtype=np.uint32)
    corpus = np.ascontiguousarray(corpus, dtype=np.uint32)
    out = np.zeros(corpus.shape[0], dtype=np.uint32)
    lib.innr_hamming_scan(_ptr(query, ctypes.c_uint32), _ptr(corpus, ctypes.c_uint32),
                          corpus.shape[0], corpus.shape[1], _ptr(out, ctypes.c_uint32))
    return out


def minhash_rows(items: np.ndarray, offsets: np.ndarray, n_slots: int) -> np.ndarray | None:
    """MinHash sketches of ragged documents: ``items`` the concatenated u64
    item hashes, ``offsets`` the (n_docs + 1,) int64 prefix -> (n_docs,
    n_slots) uint32."""
    lib = _load()
    if lib is None:
        return None
    items = np.ascontiguousarray(items, dtype=np.uint64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_docs = offsets.size - 1
    out = np.empty((n_docs, int(n_slots)), dtype=np.uint32)
    lib.innr_minhash_rows_mt(_ptr(items, ctypes.c_uint64), _ptr(offsets, ctypes.c_int64),
                             n_docs, int(n_slots), _ptr(out, ctypes.c_uint32),
                             _n_threads(n_docs))
    return out
