#!/usr/bin/env python3
"""Where the binary-search sparse scan's time goes: variant builds on one GPU.

    python3 scripts/sparse_probe.py SRC_DIR [OUT.json]

SRC_DIR holds the binary-search ``sparse_knn.cu`` (each corpus entry
searched once per query of the tile) and its headers, e.g.
``innr_tpu_torch/csrc`` of ``git archive 714fd81 innr_tpu_torch`` unpacked
under ``build/``. The script compiles four builds of it with nvcc (sm_90a):

- ``full``: the kernel as it is;
- ``no_search``: the lower-bound search replaced by one shared load at a
  slot the id picks (``x % Lq``), the match test kept;
- ``no_offer``: the per-tile offer of the keys to the top-k buffers
  (``top.offer``) left out, the keys still written;
- ``loads_only``: neither search nor offer, each entry's id and value
  folded into one sum.

and times ``innr_sparse_scan`` alone (no merge; CUDA events, median of 7)
on ``chip_smoke.py``'s WordPiece cell (10M documents x 32 entries, Zipf ids
over the 30,522-id vocabulary, 64-entry queries) at Q = 1 and Q = 16, k =
10, with the same slabs and query tile as the wrapper. It prints one line
per build and shape, then one JSON object with the card's name and power
limit (written to OUT.json too when given).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SEARCH = """          int lo = 0, len = lq;  // lower bound of x in qi[0..lq)
          while (len > 0) {
            const int half = len >> 1;
            if (qi[lo + half] < x) {
              lo += half + 1;
              len -= half + 1;
            } else {
              len = half;
            }
          }
"""
NO_SEARCH = "          int lo = static_cast<int>(x % static_cast<unsigned>(lq));\n"
OFFER = "    top.offer(k, t0, row_end, q0, n_q);\n"
NO_OFFER = "    __syncthreads();\n"
JOIN_START = "#pragma unroll\n        for (int j = 0; j < QT; ++j) {\n          const unsigned* qi"
JOIN_END = "acc[j] = __fadd_rn(acc[j], __fmul_rn(v, qv_s[j * lq + lo]));\n        }\n"
LOADS_ONLY = "        acc[0] = __fadd_rn(acc[0], v + __uint_as_float(x & 0x3F800000u));\n"


def variants(src: str) -> dict:
    for anchor in (SEARCH, OFFER, JOIN_START, JOIN_END):
        if src.count(anchor) != 1:
            raise SystemExit(f"sparse_probe: {anchor!r} is not in the source once; SRC_DIR must "
                             "hold the binary-search kernel")
    a, b = src.index(JOIN_START), src.index(JOIN_END) + len(JOIN_END)
    return {
        "full": src,
        "no_search": src.replace(SEARCH, NO_SEARCH),
        "no_offer": src.replace(OFFER, NO_OFFER),
        "loads_only": (src[:a] + LOADS_ONLY + src[b:]).replace(OFFER, NO_OFFER),
    }


def build(src_dir: Path, out: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    from innr_tpu_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants((src_dir / "sparse_knn.cu").read_text()).items():
        cu = out / f"sparse_{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", "-I", str(src_dir), "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"sparse_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"sparse_{name}.so"))
        lib.innr_sparse_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32,
                                         i32, i32, ptr]
        lib.innr_sparse_scan.restype = i32
        libs[name] = lib
    return libs


def wordpiece_cell(dev):
    """chip_smoke.py's first sparse cell (phase_sparse, WordPiece ids):
    ``(q_idx (16, 64), q_val, idx_t, val_t)`` on the card."""
    import torch

    import chip_smoke as cs

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    p = 1.0 / torch.arange(1, cs.VOCAB + 1, dtype=torch.float64, device=dev)
    cdf = (torch.cumsum(p, 0) / p.sum()).float()
    perm = torch.randperm(cs.VOCAB, generator=gen, device=dev).to(torch.int32)
    ranks = torch.stack([torch.multinomial(p.float(), cs.QUERY_NNZ, replacement=False,
                                           generator=gen) for _ in range(16)])
    q_val = torch.randn((16, cs.QUERY_NNZ), generator=gen, device=dev).abs_()
    torch.randint(-(2**31), 2**31, (cs.VOCAB,), generator=gen, device=dev, dtype=torch.int32)
    ids, vals = cs._zipf_sparse_corpus(gen, dev, perm, cdf)
    q_idx, order = cs.unsigned_sort(perm[ranks], 1)
    return q_idx, torch.gather(q_val, 1, order), ids.T.contiguous(), vals.T.contiguous()


def main() -> int:
    src_dir = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import row_scan

    if not torch.cuda.is_available():
        raise SystemExit("sparse_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build(src_dir, ROOT / "build" / "sparse_probe")
    q_idx, q_val, idx_t, val_t = wordpiece_cell(dev)
    l, n = idx_t.shape
    k, lq = 10, q_idx.shape[1]
    gpu = cs.gpu_name_and_power()
    result = {"gpu": gpu, "src": str(src_dir), "ms": {}}
    for n_q in (1, 16):
        qi, qv = q_idx[:n_q].contiguous(), q_val[:n_q].contiguous()
        tile = row_scan.row_scan_tile(n_q, k, 8 * lq, "sparse_scan")
        slab_rows = tk._slab_rows(n, -(-n_q // tile), k, dev, row_scan.ROW_TILE)
        partial = torch.empty((-(-n // slab_rows), n_q, k), dtype=torch.int64, device=dev)
        for name, lib in libs.items():
            def run(lib=lib):
                rc = lib.innr_sparse_scan(qi.data_ptr(), qv.data_ptr(), idx_t.data_ptr(),
                                          val_t.data_ptr(), None, partial.data_ptr(), n_q, n, l,
                                          lq, k, tile, slab_rows,
                                          torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"sparse_probe: {name} launch failed, cudaError {rc}")
            ms = cs._median_ms(run)
            result["ms"][f"{name}_q{n_q}"] = ms
            print(f"[sparse_probe] {name} Q={n_q}: {ms!r} ms ({gpu})", flush=True)
    print(json.dumps(result))
    if len(sys.argv) > 2:
        Path(sys.argv[2]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
