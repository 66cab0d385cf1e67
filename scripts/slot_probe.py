#!/usr/bin/env python3
"""Where the slot scans' time goes, and where the table scan overtakes the
compare scan: variant builds on one GPU.

    python3 scripts/slot_probe.py [OUT.json]

Compiles five builds of ``innr_tpu_torch/csrc/slot_knn.cu`` with nvcc
(sm_90a), by the source's switches:

- ``full``: the kernels as the package builds them;
- ``loads`` (``INNR_SLOT_PROBE=1``): every slot loaded and folded into one
  count, nothing looked up or compared;
- ``filter`` (``INNR_SLOT_PROBE=2``): slot_table's loads and filter
  lookups, its passes counted, the table never probed (slot_compare as in
  ``loads``);
- ``full_32B`` (``INNR_SLOT_TABLE_BYTES=32``): slot_table with 32 bytes of
  slots in flight per thread instead of 64;
- ``direct`` (``INNR_SLOT_FILTER=0``): slot_table without its filter, every
  (row, slot) looked up in its table directly.

It times ``innr_slot_scan`` alone (no merge; CUDA events, median of 7) with
the wrapper's slabs over ``chip_smoke.py``'s MinHash size, 10M x 128 slots
drawn over the full width of uint32 and of uint16, k = 10:

- every build of the table mode, and ``full`` and ``loads`` of the compare
  mode, at Q = 1 and Q = 16;
- the full build of each mode at every query count its tiles reach (Q =
  the tile: compare 1-4, table 1-32) and compare at Q = 8 (two tiles),
  which gives the crossover that ``kernels/slot_knn.py:COMPARE_MAX_TILE``
  holds;
- beside them a same-bytes read (``torch.sum`` of the slots viewed as
  float32);
- then ``chip_smoke.py``'s hit-heavy corpus (slots from 4 values, rows of
  it as queries): the table mode at Q = 16 (``full`` and ``direct``) and
  the compare mode at Q = 1.

It prints one line per cell, then one JSON object with the card's name and
power limit (written to OUT.json too when given).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {"full": [], "loads": ["-DINNR_SLOT_PROBE=1"], "filter": ["-DINNR_SLOT_PROBE=2"],
            "full_32B": ["-DINNR_SLOT_TABLE_BYTES=32"], "direct": ["-DINNR_SLOT_FILTER=0"]}


def build(out: Path) -> dict:
    import ctypes

    sys.path.insert(0, str(ROOT))
    from innr_tpu_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out / f"slot_{name}.so"
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *flags, "-shared", "-o", str(lib),
               str(_build.SRC_DIR / "slot_knn.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"slot_probe: nvcc failed for {name}:\n{log}")
        (out / f"slot_{name}.log").write_text(log)
        if name == "full":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[slot_probe] ptxas: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(out / f"slot_{name}.so"))
        lib.innr_slot_scan.argtypes = [i32, i32, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, i32,
                                       ptr]
        lib.innr_slot_scan.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import slot_knn as tsl

    if not torch.cuda.is_available():
        raise SystemExit("slot_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build(ROOT / "build" / "slot_probe")
    gpu = cs.gpu_name_and_power()
    result = {"gpu": gpu, "ms": {}, "read_ms": {}, "crossover": {}}
    n, s, k = cs.N_SKETCH, cs.SLOTS, 10
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 13)
    for dtype in (torch.int32, torch.int16):
        bits = torch.iinfo(dtype).bits
        slots_t = cs._random_slots(gen, n, s, dtype, dev).T.contiguous()
        qs = cs._random_slots(gen, 32, s, dtype, dev)
        read = cs._median_ms(lambda: slots_t.view(torch.float32).sum())
        result["read_ms"][f"uint{bits}"] = read
        print(f"[slot_probe] uint{bits} {n} x {s}: same-bytes read {read!r} ms ({gpu})",
              flush=True)

        def time(lib, mode, n_q, tile):
            q = qs[:n_q].contiguous()
            slab_rows = tk._slab_rows(n, -(-n_q // tile), k, dev, tsl.row_tile(bits, mode))
            partial = torch.empty((-(-n // slab_rows), n_q, k), dtype=torch.int64, device=dev)

            def run():
                rc = lib.innr_slot_scan(bits, tsl.MODES[mode][0], q.data_ptr(),
                                        slots_t.data_ptr(), None, partial.data_ptr(), n_q, n, s,
                                        k, tile, slab_rows,
                                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"slot_probe: {mode} launch failed, cudaError {rc}")
            return cs._median_ms(run)

        cells = [(name, mode, n_q) for name in VARIANTS for mode in tsl.MODES
                 for n_q in (1, 16) if mode == "table" or name == "full" or name == "loads"]
        cells += [("full", mode, tile) for mode, (_, tiles) in tsl.MODES.items() for tile in tiles
                  if tile not in (1, 16)]
        for name, mode, n_q in cells:
            tile = min(n_q, tsl.MODES[mode][1][-1])
            ms = time(libs[name], mode, n_q, tile)
            key = f"uint{bits}_{mode}_{name}_q{n_q}"
            result["ms"][key] = ms
            print(f"[slot_probe] {key} (tile {tile}): {ms!r} ms, read/kernel {read / ms!r}",
                  flush=True)
        for n_q in (1, 2, 4):
            c = result["ms"][f"uint{bits}_compare_full_q{n_q}"]
            t = result["ms"][f"uint{bits}_table_full_q{n_q}"]
            result["crossover"][f"uint{bits}_q{n_q}"] = "compare" if c <= t else "table"
        # Q = 8: two compare tiles of 4 against one table tile of 8.
        c = time(libs["full"], "compare", 8, 4)
        result["ms"][f"uint{bits}_compare_full_q8"] = c
        t = result["ms"][f"uint{bits}_table_full_q8"]
        print(f"[slot_probe] uint{bits}_compare_full_q8 (tile 4): {c!r} ms", flush=True)
        result["crossover"][f"uint{bits}_q8"] = "compare" if c <= t else "table"
        # The hit-heavy corpus of chip_smoke.py (slots from 4 values, 16 of
        # its rows as queries): every lookup passes the filter and hits.
        info = torch.iinfo(dtype)
        alphabet = torch.tensor([info.min, -1, 0, 1], dtype=dtype, device=dev)
        for a in range(0, n, 1 << 20):
            b = min(n, a + (1 << 20))
            slots_t[:, a:b] = alphabet[torch.randint(0, 4, (s, b - a), generator=gen, device=dev)]
        qs = slots_t[:, :32 * 1000:1000].T.contiguous()
        for name, mode, n_q in (("full", "table", 16), ("direct", "table", 16),
                                ("full", "compare", 1)):
            ms = time(libs[name], mode, n_q, n_q)
            key = f"uint{bits}_{mode}_{name}_q{n_q}_hit_heavy"
            result["ms"][key] = ms
            print(f"[slot_probe] {key}: {ms!r} ms", flush=True)
        del slots_t
        torch.cuda.empty_cache()
    print(json.dumps(result))
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
