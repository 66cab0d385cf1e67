#!/usr/bin/env python3
"""What the slot scan's compare compiles to on sm_90a (cuobjdump -sass).

The bound of ``slot_scan`` (``innr_tpu_torch/csrc/slot_knn.cu``) counts two
INT32 operations per slot and query: a compare and an add. This script
reads the SASS that nvcc emits for them. Run from the repository root on a
machine with the CUDA toolkit (a card is not needed):

    python3 scripts/slot_sass.py [OUT.json]

It builds the package's library (``_build.build()``), dumps the SASS of
every ``slot_scan`` instance with ``cuobjdump -sass`` and counts the
opcodes of each (an instance's count over its unrolled slot loop is about
QT times the slots it unrolls). Then it compiles probe kernels, one per
way of comparing slots (``v != q`` and an add, as the scan does;
``__vcmpne2`` / ``__vcmpeq2`` / ``__vcmpne4`` / ``__vsetne2`` and a
popcount, the SIMD-in-a-word alternatives), and lists each probe's
instructions between its loads and its store. It prints one JSON object
(written to OUT.json too when given).
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBES = r"""
#include <cuda_runtime.h>
extern "C" __global__ void ne_add(const unsigned* a, const unsigned* b, int* out) {
  int i = threadIdx.x;
  out[i] += a[i] != b[i];
}
extern "C" __global__ void ne_add_u16(const unsigned short* a, const unsigned* b, int* out) {
  int i = threadIdx.x;
  out[i] += static_cast<unsigned>(a[i]) != b[i];
}
extern "C" __global__ void vcmpne2(const unsigned* a, const unsigned* b, unsigned* out) {
  int i = threadIdx.x;
  out[i] = __vcmpne2(a[i], b[i]);
}
extern "C" __global__ void vcmpeq2(const unsigned* a, const unsigned* b, unsigned* out) {
  int i = threadIdx.x;
  out[i] = __vcmpeq2(a[i], b[i]);
}
extern "C" __global__ void vcmpne4(const unsigned* a, const unsigned* b, unsigned* out) {
  int i = threadIdx.x;
  out[i] = __vcmpne4(a[i], b[i]);
}
extern "C" __global__ void vsetne2_popc(const unsigned* a, const unsigned* b, int* out) {
  int i = threadIdx.x;
  out[i] += __popc(__vsetne2(a[i], b[i]));
}
"""

_INSTR = re.compile(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass(path: Path) -> dict:
    """Function name -> list of its SASS opcodes (with modifiers)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            m = _INSTR.search(line)
            if m:
                funcs[name].append(m.group(2))
    return funcs


def body(ops: list) -> list:
    """The instructions between a probe's last global load and its store."""
    loads = [i for i, op in enumerate(ops) if op.startswith("LDG")]
    stores = [i for i, op in enumerate(ops) if op.startswith("STG")]
    if not loads or not stores:
        return ops
    return ops[loads[-1] + 1:stores[0]]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from innr_tpu_torch.kernels import _build

    lib = _build.build()
    result = {"library": lib.name, "slot_scan": {}, "probes": {}}
    for name, ops in sass(lib).items():
        if "slot_scan" in name:
            hist = collections.Counter(op.split(".")[0] for op in ops)
            result["slot_scan"][name] = dict(hist.most_common(12))
    work = ROOT / "build" / "slot_sass"
    work.mkdir(parents=True, exist_ok=True)
    src, cubin = work / "probes.cu", work / "probes.cubin"
    src.write_text(PROBES)
    subprocess.run([_build._nvcc(), "-cubin", "-arch=sm_90a", "-O3", "-o", str(cubin), str(src)],
                   check=True)
    for name, ops in sass(cubin).items():
        result["probes"][name] = body(ops)
    for name, ops in result["probes"].items():
        print(f"[slot_sass] {name}: {' ; '.join(ops)}", flush=True)
    for name, hist in result["slot_scan"].items():
        print(f"[slot_sass] {name}: {hist}", flush=True)
    text = json.dumps(result)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
