#!/usr/bin/env python3
"""Where K1's time goes over a u8 corpus: variant builds and phase clocks on one GPU.

    python3 scripts/knn_probe.py [OUT.json [BUILDS]]

Compiles builds of ``innr_tpu_torch/csrc/knn.cu`` with nvcc (sm_90a), each
a text edit of the source at fixed anchors:

- ``full``: the kernel as it is;
- ``loads_norms``: no pair admitted (no list, re-score or offer; the
  gate's arithmetic kept live by a vote that never passes) and no
  tensor-core products or widening: the row loads and the work that
  consumes them;
- ``prefetch1``: at each tile's first chunk, each warp's first lane asks
  for its 16 rows of the next tile in the item to be prefetched into L2
  (``cp.async.bulk.prefetch.L2``, one contiguous range);
- ``ldnc`` / ``ld256``: the rows' 16-byte loads as ``ld.global.nc`` with
  ``L1::no_allocate`` (and ``L2::256B``, a 256-byte L2 fetch per miss);
- ``chunk128``: u8 items of 128 dimensions (two 16-byte vectors per row
  and thread, 8 KB per CTA in flight), not 256;
- ``chunk384``: u8 items of 384 dimensions (six vectors, 24 KB per CTA in
  flight) at two CTAs per SM (``__launch_bounds__`` minimum 2, up to 255
  registers);
- ``clocks``: the full kernel with ``clock64()`` sums per phase, read by
  each CTA's first thread: the query staging, the items (the wait for an
  item's rows, widening, ``wgmma`` and norms), the gate, the re-score
  rounds (exact dots, offers, thresholds), each as a share of the CTA's
  time; and within the rounds the first warp's exact dots and offers.

and times the scan alone (``innr_knn_scan``, the wrapper's grid, slabs and
gate terms; CUDA events, median of 7) of each build on uniform u8 codes:
1M x 768 at Q = 32 (k = 10 and 80) and Q = 1, 4M x 768 at Q = 32, k = 10;
for the ``full`` build also the scan and ``innr_knn_merge``, the re-scored
pairs per query, and the wrapper's whole call (``fused_knn_keys_batch``:
gate terms, scan, merge, host work). Prints one line per build and cell,
then one JSON object with the card's name and power limit (written to
OUT.json too when given). BUILDS (comma-separated) picks builds; all by
default.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

KERNEL = "// One warpgroup's shared memory (a TcLayout region from base) and its\n"
STAGED = "  long long per_tile = 1, items = 0;\n"
ITEM = "    const Cursor it = next;\n"
MMA_DONE = "    if (it.ch != L.n_dch - 1) continue;\n"
GATE_DONE = "    ++tile;\n"
ROUNDS_DONE = "    __syncthreads();\n    if (total > 0) publish(w, p, q0, blockIdx.x, gridDim.x);\n"
LOOP_DONE = "  write_partial(w, p, q0, blockIdx.x);\n"
ADMIT = "__reduce_or_sync(0xFFFFFFFFu, admitted); regs != 0u;"
MMA = ("#pragma unroll\n    for (int st = 0; st < kSteps; ++st)\n"
       "      Tc<T>::mma(acc, cur, st, kmajor_desc(b0 + st * 2 * NQ * 16, NQ),\n"
       "                 kmajor_desc(b1 + st * 2 * NQ * 16, NQ));\n")
TILE_START = "published = __ldcg(p.kth + q0 + tid);\n    }\n"
PREFETCH = """
    if (it.ch == 0 && p.vec && lane == 0) {
      const long long r0 = it.t0 + kTcRows + 16 * warp, r1 = min(r0 + 16, it.end);
      if (r0 < r1) {
        const T* src = static_cast<const T*>(p.rows) + static_cast<size_t>(r0) * p.d;
        const unsigned bytes = static_cast<unsigned>((r1 - r0) * p.d * sizeof(T));
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src), "r"(bytes) : "memory");
      }
    }
"""
ROW_LOAD = "*reinterpret_cast<const uint4*>(src + col)"
LD_HELPER_AT = "// The low part of an f32 operand"
LD_HELPER = """__device__ __forceinline__ uint4 ld_rows(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocateHINT.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
"""
U8_CHUNK = ("  static constexpr int kChunk = 256;\n  static constexpr int kSteps = 16;  // m64nNk16\n"
            "  static constexpr int kVecs = 4;\n")
U8_BLOCKS = "  static constexpr int kSplit = 2;   // q_hi, q_lo\n  static constexpr int kMinBlocks = 3;\n"
BATCH = "    const int n_b = min(have, 32);\n"
EXACT_DONE = "      if (cand >= w.bound[c]) cand = LLONG_MIN;\n    }\n"
OFFER_DONE = "      warp_merge(w.best + c0 * k, k, in ? cand : LLONG_MIN, lane);\n    }\n"
PHASES = ("staging", "items", "gate", "rescore", "total", "exact", "offer")


def _at(src: str, anchor: str, before: str = "", after: str = "") -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"knn_probe: {anchor!r} is not in csrc/knn.cu once")
    return src.replace(anchor, before + anchor + after)


def _swap(src: str, anchor: str, text: str) -> str:
    return _at(src, anchor).replace(anchor, text)


def _clocks(src: str) -> str:
    def add(slot: int, since: str) -> str:
        return (f"if (threadIdx.x == 0) atomicAdd(&g_clocks[{slot}], "
                f"(unsigned long long)(clock64() - {since}));\n")

    s = _at(src, KERNEL, before="__device__ unsigned long long g_clocks[8];\n")
    s = _at(s, "  const Wg<T, NQ> w(smem, L, threadIdx.x, 0);\n",
            before="  const long long t_start = clock64();\n")
    s = _at(s, STAGED, before="  " + add(0, "t_start"))
    s = _at(s, ITEM, before="    long long t_item = clock64();\n")
    s = _at(s, MMA_DONE, before="    " + add(1, "t_item") + "    long long t_gate = clock64();\n")
    s = _at(s, GATE_DONE, before="    " + add(2, "t_gate") + "    long long t_rounds = clock64();\n")
    s = _at(s, BATCH, before="    long long t_exact = clock64();\n")
    s = _at(s, EXACT_DONE, after="    " + add(5, "t_exact") + "    long long t_offer = clock64();\n")
    s = _at(s, OFFER_DONE, after="    " + add(6, "t_offer"))
    s = _at(s, ROUNDS_DONE, before="    " + add(3, "t_rounds"))
    s = _at(s, LOOP_DONE, before="  " + add(4, "t_start"))
    return s + """
extern "C" int innr_knn_clocks(void* out, int reset) {
  if (reset) {
    unsigned long long zero[8] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clocks, 8 * sizeof(unsigned long long)));
}
"""


def _ld_variant(src: str, hint: str) -> str:
    helper = LD_HELPER.replace("HINT", hint)
    return _swap(_at(src, LD_HELPER_AT, before=helper), ROW_LOAD, "ld_rows(src + col)")


def variants(src: str) -> dict:
    blocks2 = _swap(src, U8_BLOCKS, U8_BLOCKS.replace("= 3", "= 2"))
    no_gate = _swap(src, ADMIT, ADMIT.replace("admitted);", "admitted) == 0x5A5A5A5Au;"))
    return {
        "full": src,
        "loads_norms": _swap(no_gate, MMA, ""),
        "prefetch1": _at(src, TILE_START, after=PREFETCH),
        "ldnc": _ld_variant(src, ""),
        "ld256": _ld_variant(src, ".L2::256B"),
        "chunk128": _swap(src, U8_CHUNK, U8_CHUNK.replace("256", "128").replace("16;", "8;")
                          .replace("kVecs = 4", "kVecs = 2")),
        "chunk384": _swap(blocks2, U8_CHUNK, U8_CHUNK.replace("256", "384").replace("16;", "24;")
                          .replace("kVecs = 4", "kVecs = 6")),
        "clocks": _clocks(src),
    }


def build(out: Path, names=None) -> dict:
    sys.path.insert(0, str(ROOT))
    from innr_tpu_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants((_build.SRC_DIR / "knn.cu").read_text()).items():
        if names is not None and name not in names:
            continue
        cu = out / f"knn_{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", "-I", str(_build.SRC_DIR), "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"knn_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"knn_{name}.so"))
        lib.innr_knn_scan.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, f32, f32, ptr, ptr,
                                      ptr, i32, i64, i32, i32, i32, i32, i32, ptr]
        lib.innr_knn_scan.restype = i32
        lib.innr_knn_grid.argtypes = [i32, i32, i32, i32, i32, ptr]
        lib.innr_knn_grid.restype = i32
        lib.innr_knn_merge.argtypes = [ptr, ptr, i32, i32, i32, ptr]
        lib.innr_knn_merge.restype = i32
        libs[name] = lib
    if "clocks" in libs:
        libs["clocks"].innr_knn_clocks.argtypes = [ptr, i32]
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import knn as tk

    if not torch.cuda.is_available():
        raise SystemExit("knn_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build(ROOT / "build" / "knn_probe",
                 sys.argv[2].split(",") if len(sys.argv) > 2 else None)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    big = torch.randint(0, 256, (4_000_000, 768), generator=gen, device=dev, dtype=torch.uint8)
    qs = torch.randn((32, 768), generator=gen, device=dev)
    gpu = cs.gpu_name_and_power()
    result = {"gpu": gpu, "ms": {}, "clock_shares": {}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, n_q, k in ((1_000_000, 32, 10), (1_000_000, 32, 80), (1_000_000, 1, 10),
                      (4_000_000, 32, 10)):
        rows, q = big[:n], qs[:n_q].contiguous()
        cell = f"{n // 1_000_000}M_q{n_q}_k{k}"
        qmeta, m_abs, m_aux, counter = tk._gate_terms(q, rows, "dot")
        for name, lib in libs.items():
            info = (ctypes.c_int * 2)()
            lib.innr_knn_grid(2, n_q, 768, k, 0, info)
            q_tile, resident = info[0], max(1, info[1])
            slab = tk._slab_rows(n, -(-n_q // q_tile), k, dev, tk._ROW_TILE, resident, 1)
            partial = torch.empty((-(-n // slab), n_q, k), dtype=torch.int64, device=dev)
            kth = tk.shared_keys(n_q, partial.shape[0], dev)

            def run(lib=lib, slab=slab, partial=partial, kth=kth):
                kth.fill_(tk._INT32_MIN)
                rc = lib.innr_knn_scan(
                    q.data_ptr(), rows.data_ptr(), 2, None, None, None, None, qmeta.data_ptr(), m_abs,
                    m_aux, counter.data_ptr(), kth.data_ptr(), partial.data_ptr(), n_q, n, 768,
                    k, 0, slab, 0, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"knn_probe: {name} launch failed, cudaError {rc}")
            if name == "clocks":
                sums = (ctypes.c_ulonglong * 8)()
                lib.innr_knn_clocks(sums, 1)
                run()
                torch.cuda.synchronize()
                lib.innr_knn_clocks(sums, 0)
                shares = {p: sums[i] / sums[4] for i, p in enumerate(PHASES) if p != "total"}
                ctas = -(-n // slab) * -(-n_q // q_tile)
                shares["cta_ms_at_1.755GHz"] = sums[4] / ctas / 1.755e6
                result["clock_shares"][cell] = shares
                print(f"[knn_probe] clock shares {cell}: {shares!r} ({gpu})", flush=True)
                continue
            if name == "full":
                counter.zero_()
                run()
                result["pairs_per_query"] = result.get("pairs_per_query", {})
                result["pairs_per_query"][cell] = int(counter.item()) / n_q
                print(f"[knn_probe] {cell}: re-scored {int(counter.item()) / n_q!r} pairs per "
                      f"query", flush=True)
            ms = cs._median_ms(run)
            result["ms"][f"{name}_{cell}"] = ms
            print(f"[knn_probe] {name} {cell}: scan {ms!r} ms (query tile {q_tile}, "
                  f"{resident} CTAs per SM of {sms}, slab {slab} rows) ({gpu})", flush=True)
            if name == "full":
                out = torch.empty((n_q, k), dtype=torch.int64, device=dev)

                def run_merge(lib=lib, run=run, partial=partial, out=out):
                    run()
                    lib.innr_knn_merge(partial.data_ptr(), out.data_ptr(), n_q, partial.shape[0],
                                       k, torch.cuda.current_stream().cuda_stream)
                ms = cs._median_ms(run_merge)
                result["ms"][f"scan_merge_{cell}"] = ms
                print(f"[knn_probe] full {cell}: scan + merge {ms!r} ms ({gpu})", flush=True)
        call = cs._median_ms(lambda: tk.fused_knn_keys_batch(q, rows, None, k, "dot"))
        result["ms"][f"call_{cell}"] = call
        print(f"[knn_probe] call {cell}: {call!r} ms ({gpu})", flush=True)
    print(json.dumps(result))
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
