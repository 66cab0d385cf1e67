#!/usr/bin/env python3
"""The b1 tensor-core rate of the card, and where the row-per-thread packed
scan's time goes: variant builds on one GPU.

    python3 scripts/packed_probe.py PARENT_ROOT [OUT.json]
    python3 scripts/packed_probe.py --this [OUT.json]

PARENT_ROOT is a tree whose ``innr_tpu_torch`` holds the row-per-thread
``packed_scan`` (one corpus row per thread, ``__popc`` per word and query,
every row offered to the CTA's top-k), e.g. ``git archive 302b9c8
innr_tpu_torch`` unpacked under ``build/ab_parent``. The script:

1. Rates (register-only loops, every SM busy; CUDA events, median of 7):
   - ``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc``;
   - ``wgmma.mma_async ... m64n128k256.s32.b1.b1.and.popc`` with A from
     registers and with A from shared memory, if ptxas takes them for
     sm_90a (the log says which);
   - ``__popc`` (``popc.b32``) for comparison.
   A b1 rate is counted in bit products per second: m x n x k of every
   MMA, each an AND and an add of the popcount.
2. Times four builds of PARENT_ROOT's ``packed_knn.cu`` (sm_90a):
   - ``full``: the kernel as it is;
   - ``no_offer``: ``top.offer`` left out, the keys still written;
   - ``xor``: the popcounts replaced by one XOR of the row's words;
   - ``loads_only``: the XOR and no offer;
   alone (``innr_packed_scan``, no merge; the parent wrapper's query tile
   and slabs), and the parent's whole call (``fused_packed_keys_batch``:
   the wrapper's torch ops, the scan and ``knn_merge``) and the full scan
   followed by the merge, at ``chip_smoke.py``'s packed cells: binary 30M
   x 768 bits and ternary 15M x 768 at Q = 16, k = 10; 1M rows at Q = 1,
   k = 40; 1M rows at ``TwoStageIndex``'s coarse shape, Q = 32, k = 256.

With ``--this`` it times this tree's scan instead, at the same cells: the
whole call, ``packed_scan`` + ``packed_merge``, and ``packed_scan`` alone
(the library call zeroes the per-query k-th keys first, as every pass
does), and ``packed_scan`` alone in a variant build of this tree's
``packed_knn.cu``, ``xor_mma`` (each b1 MMA replaced by one XOR of its
operands into the accumulator: loads and the gate without the tensor
cores).

It prints one line per measurement and then one JSON object with the
card's name and power limit (written to OUT.json too when given).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKS_PER_SM = 4
ITERS = 4096

RATES_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ void mma_b1(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Eight independent accumulators per warp, every warp of every block.
__global__ void mma_b1_loop(const unsigned* in, int* out, int iters) {
  const unsigned* p = in + (threadIdx.x & 31) * 8;
  const unsigned a0 = p[0], a1 = p[1], a2 = p[2], a3 = p[3], b0 = p[4], b1 = p[5];
  int d[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_b1(d[j], a0, a1, a2, a3, b0, b1);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Eight independent popcounts per thread and iteration.
__global__ void popc_loop(const unsigned* in, int* out, int iters) {
  unsigned x[8];
  int s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = in[(threadIdx.x & 31) * 8 + j];
    s[j] = 0;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int c;
      asm volatile("popc.b32 %0, %1;\n" : "=r"(c) : "r"(x[j] ^ static_cast<unsigned>(i)));
      s[j] += c;
    }
  }
  int t = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) t += s[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

extern "C" int run_mma_b1(int blocks, int threads, const void* in, void* out, int iters,
                          void* stream) {
  mma_b1_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(in), static_cast<int*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run_popc(int blocks, int threads, const void* in, void* out, int iters,
                        void* stream) {
  popc_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(in), static_cast<int*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""

# wgmma m64n128k256 b1: 64 s32 accumulators per thread of a warpgroup; B
# (128 x 256 bits) K-major in shared memory without swizzle (two 16-byte
# column chunks, 128 rows each), A (64 x 256 bits) from registers (rs) or
# the same layout in shared memory (ss).
_ACC = ", ".join(f"%{i}" for i in range(64))
WGMMA_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ uint64_t desc(const void* p, int rows) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) | (static_cast<uint64_t>(rows & 0x3FFF) << 16) |
         (static_cast<uint64_t>(8) << 32);
}

#define ACC64(d) """ + " ".join(f'"+r"(d[{i}]),' for i in range(63)) + r""" "+r"(d[63])

__device__ __forceinline__ void step(int (&d)[64], unsigned a0, unsigned a1, unsigned a2,
                                     unsigned a3, uint64_t a_desc, uint64_t b_desc) {
#ifdef INNR_WGMMA_SS
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc {""" + _ACC + r"""}, %64, %65, p;\n}\n"
      : ACC64(d)
      : "l"(a_desc), "l"(b_desc), "r"(1));
#else
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc {""" + _ACC + r"""}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(1));
#endif
}

__global__ void __launch_bounds__(128) wgmma_b1_loop(const unsigned* in, int* out,
                                                                int iters) {
  __shared__ __align__(128) unsigned b_s[128 * 8];
  __shared__ __align__(128) unsigned a_s[64 * 8];
  for (int i = threadIdx.x; i < 128 * 8; i += 128) b_s[i] = in[i % 256];
  for (int i = threadIdx.x; i < 64 * 8; i += 128) a_s[i] = in[(i + 7) % 256];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const unsigned* p = in + (threadIdx.x & 31) * 8;
  const unsigned a0 = p[0], a1 = p[1], a2 = p[2], a3 = p[3];
  const uint64_t bd = desc(b_s, 128), ad = desc(a_s, 64);
  int d[64] = {};
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) step(d, a0, a1, a2, a3, ad, bd);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int s = 0;
#pragma unroll
  for (int j = 0; j < 64; ++j) s += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run_wgmma_b1(int blocks, int threads, const void* in, void* out, int iters,
                            void* stream) {
  wgmma_b1_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(in), static_cast<int*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""

OFFER = "    top.offer(k, t0, row_end, q0, n_q);\n"
NO_OFFER = "    __syncthreads();\n"
SCORE = "        for (int j = 0; j < QT; ++j) acc[j] += word_score<kKind>(p, m, a[j], b[j]);\n"
XOR = "        for (int j = 0; j < 1; ++j) acc[j] ^= static_cast<int>(p ^ m);\n"


def variants(src: str) -> dict:
    for anchor in (OFFER, SCORE):
        if src.count(anchor) != 1:
            raise SystemExit(f"packed_probe: {anchor!r} is not in the source once; PARENT_ROOT "
                             "must hold the row-per-thread kernel")
    return {
        "full": src,
        "no_offer": src.replace(OFFER, NO_OFFER),
        "xor": src.replace(SCORE, XOR),
        "loads_only": src.replace(SCORE, XOR).replace(OFFER, NO_OFFER),
    }


def _nvcc_cmd(src: Path, out: Path, extra=()) -> list:
    from innr_tpu_torch.kernels import _build

    return [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-shared", *extra, "-o", str(out), str(src)]


def build(parent_csrc: Path, out: Path) -> tuple[dict, dict, dict]:
    """(scan variant libraries, rate libraries, ptxas / nvcc logs)."""
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in variants((parent_csrc / "packed_knn.cu").read_text()).items():
        cu = out / f"packed_{name}.cu"
        cu.write_text(text)
        jobs[f"scan_{name}"] = _nvcc_cmd(cu, cu.with_suffix(".so"), ("-I", str(parent_csrc)))
    rates = out / "rates.cu"
    rates.write_text(RATES_CU)
    jobs["rates"] = _nvcc_cmd(rates, rates.with_suffix(".so"))
    wg = out / "wgmma_b1.cu"
    wg.write_text(WGMMA_CU)
    jobs["wgmma_rs"] = _nvcc_cmd(wg, out / "wgmma_rs.so")
    jobs["wgmma_ss"] = _nvcc_cmd(wg, out / "wgmma_ss.so", ("-DINNR_WGMMA_SS",))
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True) for name, cmd in jobs.items()}
    scans, rate_libs, logs = {}, {}, {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        so = Path(jobs[name][jobs[name].index("-o") + 1])
        if proc.returncode != 0:
            if name.startswith("wgmma"):
                print(f"[packed_probe] {name}: nvcc / ptxas refused it:\n{logs[name]}", flush=True)
                continue
            raise SystemExit(f"packed_probe: nvcc failed for {name}:\n{logs[name]}")
        lib = ctypes.CDLL(str(so))
        if name.startswith("scan_"):
            lib.innr_packed_scan.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32,
                                             i32, i32, ptr]  # the parent's signature
            lib.innr_packed_scan.restype = i32
            scans[name.removeprefix("scan_")] = lib
        else:
            rate_libs[name] = lib
    return scans, rate_libs, logs


def rates(rate_libs: dict, dev, gpu: str) -> dict:
    """Sustained rates of the register-only loops: b1 bit products per
    second for the MMAs, popcounts per second for popc."""
    import torch

    import chip_smoke as cs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    inp = torch.randint(-(2**31), 2**31, (256,), dtype=torch.int32, device=dev)
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    cases = [("mma_sync_m16n8k256", "rates", "run_mma_b1", 256, 8 * 16 * 8 * 256 / 32),
             ("popc", "rates", "run_popc", 256, 8)]
    cases += [(f"wgmma_m64n128k256_{v}", f"wgmma_{v}", "run_wgmma_b1", 128,
               8 * 64 * 128 * 256 / 128) for v in ("rs", "ss") if f"wgmma_{v}" in rate_libs]
    result = {}
    for name, lib_name, symbol, threads, per_thread_iter in cases:
        fn = getattr(rate_libs[lib_name], symbol)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(fn=fn, threads=threads):
            rc = fn(blocks, threads, inp.data_ptr(), out.data_ptr(), ITERS,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"packed_probe: {name} launch failed, cudaError {rc}")

        ms = cs._median_ms(run)
        per_s = blocks * threads * ITERS * per_thread_iter / (ms * 1e-3)
        unit = "popcounts" if name == "popc" else "b1 bit products"
        result[name] = {"ms": ms, "per_s": per_s}
        print(f"[packed_probe] {name}: {ms!r} ms, {per_s!r} {unit} per s ({gpu})", flush=True)
    return result


def cells(dev) -> list:
    """``(name, kind, queries, corpus planes (W, N), k)`` at chip_smoke.py's
    packed cells (phase_packed's draws) and TwoStageIndex's coarse shape."""
    import torch

    import chip_smoke as cs

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    w = 24
    bw = cs.words(gen, (30_000_000, w), dev)
    tp, tn = cs.planes(gen, "ternary", (15_000_000, w), dev)
    (qb,), (qtp, qtn) = cs.planes(gen, "binary", (32, w), dev), cs.planes(gen, "ternary", (32, w),
                                                                          dev)
    bt, pt, nt = bw.T.contiguous(), tp.T.contiguous(), tn.T.contiguous()
    del bw, tp, tn
    b1, p1, n1 = (x[:, :1_000_000].contiguous() for x in (bt, pt, nt))
    return [
        ("binary 30M Q=16 k=10", (qb[:16].contiguous(),), (bt,), 10),
        ("ternary 15M Q=16 k=10", (qtp[:16].contiguous(), qtn[:16].contiguous()), (pt, nt), 10),
        ("binary 1M Q=1 k=40", (qb[:1].contiguous(),), (b1,), 40),
        ("ternary 1M Q=1 k=40", (qtp[:1].contiguous(), qtn[:1].contiguous()), (p1, n1), 40),
        ("binary 1M Q=32 k=256", (qb,), (b1,), 256),
        ("ternary 1M Q=32 k=256", (qtp, qtn), (p1, n1), 256),
    ]


def split(scans: dict, dev, gpu: str) -> dict:
    """The parent kernel's variant builds alone, the full scan + merge, and
    the parent's whole call, per cell (ms)."""
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import _build
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import packed_knn as tpk
    from innr_tpu_torch.kernels import row_scan

    parent_lib = _build.load()
    result = {}
    for name, qs, planes_t, k in cells(dev):
        n_q, w = qs[0].shape
        n = planes_t[0].shape[1]
        binary = len(planes_t) == 1
        tile = row_scan.row_scan_tile(n_q, k, 4 * len(planes_t) * w, "packed_scan")
        slab_rows = tk._slab_rows(n, -(-n_q // tile), k, dev, row_scan.ROW_TILE)
        n_slabs = -(-n // slab_rows)
        partial = torch.empty((n_slabs, n_q, k), dtype=torch.int64, device=dev)
        out = torch.empty((n_q, k), dtype=torch.int64, device=dev)
        args = (0 if binary else 1, qs[0].data_ptr(), None if binary else qs[1].data_ptr(),
                planes_t[0].data_ptr(), None if binary else planes_t[1].data_ptr(), None,
                partial.data_ptr(), n_q, n, w, k, tile, slab_rows)
        times = {}

        def scan(lib):
            rc = lib.innr_packed_scan(*args, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"packed_probe: scan launch failed, cudaError {rc}")

        def scan_merge():
            scan(scans["full"])
            rc = parent_lib.innr_knn_merge(partial.data_ptr(), out.data_ptr(), n_q, n_slabs, k,
                                           torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"packed_probe: merge launch failed, cudaError {rc}")

        times["call"] = cs._median_ms(lambda: tpk.fused_packed_keys_batch(qs, planes_t, k))
        times["scan+merge"] = cs._median_ms(scan_merge)
        for variant, lib in scans.items():
            times[variant] = cs._median_ms(lambda lib=lib: scan(lib))
        result[name] = {"query_tile": tile, "slabs": n_slabs, **times}
        print(f"[packed_probe] {name} (query tile {tile}, {n_slabs} slabs): "
              + ", ".join(f"{v} {t!r} ms" for v, t in times.items()) + f" ({gpu})", flush=True)
        del partial, out
    return result


MMA = """  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
"""
XOR_MMA = "  d[0] ^= a0 ^ a1 ^ a2 ^ a3 ^ b.x ^ b.y;\n"


def this_variants(csrc: Path, out: Path) -> dict:
    """Variant builds of this tree's packed_knn.cu, by name."""
    src = (csrc / "packed_knn.cu").read_text()
    for anchor in (MMA,):
        if src.count(anchor) != 1:
            raise SystemExit(f"packed_probe: {anchor!r} is not in this tree's source once")
    texts = {"xor_mma": src.replace(MMA, XOR_MMA)}
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"this_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(_nvcc_cmd(cu, cu.with_suffix(".so"), ("-I", str(csrc))),
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"packed_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"this_{name}.so"))
        lib.innr_packed_scan.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                         i32, i64, i32, i32, i32, i32, i32, ptr]
        lib.innr_packed_scan.restype = i32
        libs[name] = lib
    return libs


def split_this(dev, gpu: str) -> dict:
    """This tree's pass per cell (ms): the whole call, scan + merge, and the
    scan alone (also in the variant builds), with its query tile, staging
    and slabs."""
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import _build
    from innr_tpu_torch.kernels import packed_knn as tpk

    lib = _build.load()
    variants = {"full": lib, **this_variants(_build.SRC_DIR, ROOT / "build" / "packed_probe")}
    result = {}
    for name, qs, planes_t, k in cells(dev):
        n_q, w = qs[0].shape
        n = planes_t[0].shape[1]
        binary = len(planes_t) == 1
        tl, slab_rows, n_slabs = tpk._plan(lib, binary, n_q, w, n, k, dev)
        partial = torch.empty((n_slabs, n_q, k), dtype=torch.int64, device=dev)
        out = torch.empty((n_q, k), dtype=torch.int64, device=dev)
        kth = torch.empty((n_q,), dtype=torch.int32, device=dev)

        def run(lib, merge: bool) -> None:
            rc = lib.innr_packed_scan(
                0 if binary else 1, qs[0].data_ptr(), None if binary else qs[1].data_ptr(),
                planes_t[0].data_ptr(), None if binary else planes_t[1].data_ptr(), None,
                kth.data_ptr(), partial.data_ptr(), out.data_ptr() if merge else None, None, None,
                n_q, n, w, k, tl.query_tile, int(tl.resident), slab_rows,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"packed_probe: launch failed, cudaError {rc}")

        times = {"call": cs._median_ms(lambda: tpk.fused_packed_keys_batch(qs, planes_t, k)),
                 "scan+merge": cs._median_ms(lambda: run(lib, True))}
        for variant, vlib in variants.items():
            times["scan" if variant == "full" else f"scan_{variant}"] = cs._median_ms(
                lambda vlib=vlib: run(vlib, False))
        result[name] = {"query_tile": tl.query_tile, "resident_queries": tl.resident,
                        "slabs": n_slabs, **times}
        print(f"[packed_probe] this tree, {name} (query tile {tl.query_tile}, {n_slabs} slabs): "
              + ", ".join(f"{v} {t!r} ms" for v, t in times.items()) + f" ({gpu})", flush=True)
        del partial, out
    return result


def main() -> int:
    if sys.argv[1] == "--this":
        sys.path.insert(0, str(ROOT))
        import torch

        import chip_smoke as cs

        if not torch.cuda.is_available():
            raise SystemExit("packed_probe: no CUDA device")
        gpu = cs.gpu_name_and_power()
        result = {"gpu": gpu, "split_this": split_this(torch.device("cuda", 0), gpu)}
        print(json.dumps(result))
        if len(sys.argv) > 2:
            Path(sys.argv[2]).parent.mkdir(parents=True, exist_ok=True)
            Path(sys.argv[2]).write_text(json.dumps(result, indent=1))
        return 0
    parent = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(parent))  # the parent's innr_tpu_torch
    sys.path.append(str(ROOT))       # chip_smoke's cells and helpers
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("packed_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    scans, rate_libs, logs = build(parent / "innr_tpu_torch" / "csrc",
                                   ROOT / "build" / "packed_probe")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[packed_probe] ptxas {name}: {line.strip()}", flush=True)
    gpu = cs.gpu_name_and_power()
    result = {"gpu": gpu, "parent": str(parent),
              "wgmma_b1": {v: f"wgmma_{v}" in rate_libs for v in ("rs", "ss")},
              "rates": rates(rate_libs, dev, gpu), "split": split(scans, dev, gpu)}
    print(json.dumps(result))
    if len(sys.argv) > 2:
        Path(sys.argv[2]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[2]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
