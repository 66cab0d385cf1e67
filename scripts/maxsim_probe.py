#!/usr/bin/env python3
"""Where the f32 MaxSim kernel's time goes: variant builds and phase clocks on one GPU.

    python3 scripts/maxsim_probe.py [OUT.json]

Compiles builds of ``innr_tpu_torch/csrc/maxsim.cu`` with nvcc (sm_90a), each
a text edit of the source at fixed anchors:

- ``full``: the kernel as it is;
- ``no_rescore``: the exact re-score of the gate's candidates left out (the
  gate, the candidate scan and the lanes' search kept);
- ``no_chunks``: no chunk of any item scored (no wgmma, gate or re-score;
  staging, norms, sums and token lists kept);
- ``staging_only``: ``no_chunks`` without the token norms;
- ``clocks``: the full kernel with ``clock64()`` sums per phase, read by the
  first thread of each warpgroup: the wait for an item's rows (and the
  barrier after it), the norms, the wgmma, the gate (from the wgmma's end
  to the re-score), the re-score, the tail (the document's sums, the next
  token list and the item's last barrier), each as a share of the item.

and times each on ``chip_smoke.py``'s ColBERT cell (200K documents x 180 x
128 f32 tokens, ragged lengths, 32 query tokens) at B = 1 and B = 16 with
the wrapper's tiling (CUDA events, median of 7). Prints one line per build
and shape, then one JSON object with the card's name and power limit
(written to OUT.json too when given).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RESCORE = "          if (g < total) {"
CHUNKS = "for (int c0 = c_first; c0 < cnt; c0 += c_step) {"
NORMS = "for (int p0 = 0; p0 < cnt; p0 += kThreads / 4) {"
KERNEL = "template <int TPW, int kCtas, bool kAsync>\n__global__"
ITEM = "    if (it.doc >= n) break;\n"
WAITED = "    const int cnt = min(ts, seg_cnt - cur.part * ts);\n"
NORMED = "    const uint32_t d0 = smem_u32(db);\n"
BLOCKS = "        for (int k0 = 0; k0 < dp; k0 += (resident ? dp : kb)) {\n"
FENCE = ("#pragma unroll\n          for (int a = 0; a < TPW; ++a)\n#pragma unroll\n"
         "            for (int i = 0; i < 32; ++i) fence_operand(acc[a][i]);\n"
         "          wgmma_fence();\n")
WAIT = "          wgmma_wait<0>();\n"
ROUNDS = "        for (int g0 = 0; g0 < total; g0 += 32) {"
PASS_END = ("      }\n#pragma unroll\n      for (int a = 0; a < TPW; ++a)\n#pragma unroll\n"
            "        for (int h = 0; h < 2; ++h)\n          if (rowv")
TAIL = "    if (last_part && it.hi == td) {"
NEXT = "    cur = advance(cur, seg_cnt, ts);"
PHASES = ("wait", "norms", "wgmma", "gate", "rescore", "tail")


def _at(src: str, anchor: str, before: str = "", after: str = "") -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"maxsim_probe: {anchor!r} is not in csrc/maxsim.cu once")
    return src.replace(anchor, before + anchor + after)


def _clocks(src: str) -> str:
    def add(slot: int, since: str) -> str:
        return (f"if ((threadIdx.x & 127) == 0) atomicAdd(&g_clocks[{slot}], "
                f"(unsigned long long)(clock64() - {since}));\n")

    s = _at(src, KERNEL, before="__device__ unsigned long long g_clocks[8];\n")
    s = _at(s, ITEM, after="    long long t_item = clock64();\n")
    s = _at(s, WAITED, before="    " + add(0, "t_item") + "    long long t_norm = clock64();\n")
    s = _at(s, NORMED, before="    " + add(1, "t_norm"))
    s = _at(s, BLOCKS, before="        long long t_gate = 0;\n")
    s = _at(s, FENCE, before="          long long t_mma = clock64();\n")
    s = _at(s, WAIT, after="          " + add(2, "t_mma") + "          t_gate = clock64();\n")
    s = _at(s, ROUNDS, before=add(3, "t_gate") + "        long long t_rescore = clock64();\n")
    s = _at(s, PASS_END, before="        " + add(4, "t_rescore"))
    s = _at(s, TAIL, before="    long long t_tail = clock64();\n")
    s = _at(s, NEXT, before=add(5, "t_tail") + "    " + add(6, "t_item"))
    return s + """
extern "C" int innr_maxsim_clocks(void* out, int reset) {
  if (reset) {
    unsigned long long zero[8] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clocks, 8 * sizeof(unsigned long long)));
}
"""


def _swap(src: str, anchor: str, text: str) -> str:
    return _at(src, anchor).replace(anchor, text)


def variants(src: str) -> dict:
    no_chunks = _swap(src, CHUNKS, CHUNKS.replace("c0 < cnt", "c0 < 0"))
    return {
        "full": src,
        "no_rescore": _swap(src, RESCORE, "          if (false) {"),
        "no_chunks": no_chunks,
        "staging_only": _swap(no_chunks, NORMS, NORMS.replace("p0 < cnt", "p0 < 0")),
        "clocks": _clocks(src),
    }


def build(out: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    from innr_tpu_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants((_build.SRC_DIR / "maxsim.cu").read_text()).items():
        cu = out / f"maxsim_{name}.cu"
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
            raise SystemExit(f"maxsim_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"maxsim_{name}.so"))
        lib.innr_maxsim_scores.argtypes = [ptr, ptr, ptr, ptr, f32, ptr, ptr, i32, i32, i32, i32,
                                           i64, i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.innr_maxsim_scores.restype = i32
        libs[name] = lib
    libs["clocks"].innr_maxsim_clocks.argtypes = [ptr, i32]
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import maxsim_kernel as tm

    if not torch.cuda.is_available():
        raise SystemExit("maxsim_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build(ROOT / "build" / "maxsim_probe")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    docs, mask, _ = cs._colbert_corpus(gen, dev)
    n, td, d = docs.shape
    qs = torch.randn((16, cs.MAXSIM_TQ, d), generator=gen, device=dev)
    qs = qs / qs.norm(dim=2, keepdim=True)
    gpu = cs.gpu_name_and_power()
    result = {"gpu": gpu, "ms": {}, "clock_shares": {}}
    for n_b in (1, 16):
        q = qs[:n_b].contiguous()
        tq = q.shape[1]
        qpt, mt, tpw, ts, seg, ctas, kb = tm._tiling(n_b, tq, td, d)
        qterm = tm.maxsim_query_terms(q).contiguous()
        out = torch.empty((n_b, n), device=dev)
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        for name, lib in libs.items():
            def run(lib=lib):
                rc = lib.innr_maxsim_scores(
                    q.data_ptr(), docs.data_ptr(), mask.data_ptr(), qterm.data_ptr(),
                    tm.maxsim_margin(d).abs, counter.data_ptr(), out.data_ptr(), n_b, tq, td, d,
                    n, qpt, mt, tpw, ts, seg, ctas, kb, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"maxsim_probe: {name} launch failed, cudaError {rc}")
            if name == "clocks":
                sums = (ctypes.c_ulonglong * 8)()
                lib.innr_maxsim_clocks(sums, 1)
                run()
                torch.cuda.synchronize()
                lib.innr_maxsim_clocks(sums, 0)
                shares = {p: sums[i] / sums[6] for i, p in enumerate(PHASES)}
                result["clock_shares"][f"b{n_b}"] = shares
                print(f"[maxsim_probe] clock shares B={n_b}: {shares!r} ({gpu})", flush=True)
                continue
            ms = cs._median_ms(run)
            result["ms"][f"{name}_b{n_b}"] = ms
            print(f"[maxsim_probe] {name} B={n_b}: {ms!r} ms ({gpu})", flush=True)
    print(json.dumps(result))
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
