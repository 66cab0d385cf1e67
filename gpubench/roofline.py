"""Operation and byte counts of the exact top-k scan, and the H100's peaks.

The bound of a call is the least time the card could take for its work,
whatever kernel does it: the larger of its bytes over the memory's rate and
its operations over the fastest unit that gives float32-accurate products.

- Bytes: the corpus rows, their squared norms (L2) and their alive mask
  (one byte a row, where rows are deleted), and the queries, each read
  once; the (value, id) outputs written once.
- Operations: 2 Q N D multiply-adds' worth, Q the call's real queries
  (a MicroBatcher bucket's pad rows are not counted). float32 rows count
  against TF32's tensor-core rate, 495 TFLOP/s: no float32-accurate product
  runs faster (3xTF32 and bf16x3 are slower), so no implementation can read
  over 100%. bfloat16 rows count against 989 TFLOP/s.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense, at its
700 W power limit; a card set lower is named beside every reading
(``nvidia-smi``'s ``power.limit``).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 495e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}
OUT_BYTES = 8  # a float32 value and an int32 id per result


def knn_bytes(rows: int, dim: int, queries: int, k: int, dtype: str = "float32",
              norms: bool = False, mask: bool = False) -> int:
    return (rows * dim * ITEMSIZE[dtype] + rows * (4 * norms + mask)
            + queries * dim * 4 + queries * k * OUT_BYTES)


def knn_ops(rows: int, dim: int, queries: int) -> int:
    return 2 * queries * rows * dim


def knn_bound_s(rows: int, dim: int, queries: int, k: int, dtype: str = "float32",
                norms: bool = False, mask: bool = False) -> tuple:
    """``(seconds, "bytes" | "ops")``: the least time of one scan."""
    t_bytes = knn_bytes(rows, dim, queries, k, dtype, norms, mask) / HBM_BYTES_PER_S
    t_ops = knn_ops(rows, dim, queries) / PEAK_OPS_PER_S[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")


def call_bound_s(cfg: dict, queries: int) -> float:
    """The bound of one call of a configuration, in seconds."""
    return knn_bound_s(cfg["rows"], cfg["dim"], queries, cfg["k"], cfg["dtype"],
                       norms=cfg["metric"] == "l2",
                       mask=cfg.get("delete_fraction", 0) > 0)[0]
