"""Nearest-centroid assignment: the CUDA kernel and its plain version.

Replaces the TPU kernel ``innr_tpu/kernels/assign.py:_nearest_kernel``
(launched by ``nearest_centroid``), the full-corpus pass of the k-means
behind :func:`innr_tpu_torch.prune.cluster_reorder` and
:class:`innr_tpu_torch.ivf.IVFIndex`. The kernel is ``csrc/assign.cu``: it
scores every (row, centroid) pair on the tensor cores in TF32, keeps each
row's shortlist of centroids within :func:`shortlist_margin` of its best,
and re-scores the shortlist with the exact FP32 FMA arithmetic, so its
result is that of the FMA scan bit for bit. Its source note says what
bounds it on the H100.

Each row gets the index of its nearest centroid by squared L2, evaluated
as ``argmin_c ||c||^2 - 2 x.c`` (the JAX kernel's ``argmax_c x.c -
||c||^2/2`` up to an exact factor of -2). Ties go to the lowest centroid.
NaN scores rank below every number, so a row whose every score is NaN
(a NaN row) gets 0. Rows holding +-inf are not held to the JAX kernel,
whose result for them depends on its 2048-centroid tiling (ROADMAP R6).

Dispatch: a CUDA tensor runs the kernel for every KC (the JAX package hands
KC > 4 x 2048 to XLA; this package has no such gate), or the call raises; a
CPU tensor, or :func:`innr_tpu_torch.config.force_reference`, runs the
plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from innr_tpu_torch import config
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import composite_keys, split_composite, total_order_key_f32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_MAX = 2**31 - 1
# Elements of the (rows, KC) score block the plain version holds at a time.
_PLAIN_CHUNK = 1 << 25

# The module-level state below (launch counts, the last launch's
# statistics) is diagnostics only, read by tests and chip_smoke.py: every
# call allocates its own scratch tensors, so concurrent calls (a
# MicroBatcher's flush workers) share none; a count bumped by two threads at
# once may lose one.
# Kernel launches, in all and by row dtype. Incremented only where the
# kernel launches.
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0, "uint8": 0}
# The last launch's (rows, (tiles, 2) device counts [shortlist, largest row]).
_LAST_SHORTLIST = None
_ROW_TILE = 128  # csrc/assign.cu: rows per CTA
# Rows and centroids whose norm is not below this (or not finite) are
# re-scored against every centroid: the bound below assumes no overflow.
_REGULAR_NORM = 2.0**50

_U = 2.0**-24  # unit roundoff of float32


class Margin(NamedTuple):
    """The kernel's shortlist margin for dimension D: the approximate score
    s~ = ||c||^2 - 2 a~ (a~ the TF32 tensor-core dot) lies within

        T = kappa ||x|| ||c|| + tau |c2| + abs_norm ||c|| + abs_const

    of the exact score fl(||c||^2 - 2 dot_fma(x, c)) (c2 = ||c||^2), for
    rows and centroids with norms below 2^50."""

    kappa: float
    tau: float
    abs_norm: float
    abs_const: float


def shortlist_margin(d: int) -> Margin:
    """The bound the kernel's shortlist uses, with P = sum |x_i c_i| <=
    ||x|| ||c|| and u = 2^-24:

    - TF32 operands: the tensor core truncates each f32 operand to 10
      mantissa bits (relative error below 2^-10; rounding would be 2^-11),
      so each product is off by at most 2 2^-10 + 2^-20 of itself; the
      products are exact in f32 and their f32 accumulation, in an order and
      with a rounding (truncation, possibly) the hardware does not state,
      adds at most 2 (D + 8) 2^-23 (1 + 2^-8) P. Together eta P.
    - The exact FMA chain: gamma_D P with gamma_D = D u / (1 - D u).
    - Roundings of s (u |s|), of s~ (u |s~|), and of s~ +- T in the
      kernel's compares, each at most u (|c2| + 2 (1 + eta) P).
    - Flushed subnormal operands and underflowing products: at most 2^-126
      per term, D 2^-126 (||c|| + ||x|| + 1) in all, with ||x|| < 2^50.

    kappa = 2 (2 gamma_D + 2 eta + 2 u (2 + gamma_D + eta) + 6 u (1 + eta)),
    tau = 2 (6 u); both with a safety factor of 2, which also covers the
    f32 roundings of the norms and of T itself (each a few u relative)."""
    d = int(d)
    gamma = d * _U / (1.0 - d * _U)
    eta = 2 * 2.0**-10 + 2.0**-20 + 2 * (d + 8) * 2.0**-23 * (1 + 2.0**-8)
    kappa = 2 * (2 * gamma + 2 * eta + 2 * _U * (2 + gamma + eta) + 6 * _U * (1 + eta))
    return Margin(kappa=kappa, tau=2 * 6 * _U, abs_norm=2 * 2 * d * 2.0**-126,
                  abs_const=2 * 2 * d * (2.0**-76 + 2.0**-126))


def _centroid_terms(cn, d: int):
    """(KC, 4) float32 ``(||c||^2, ||c||, tc, 0)`` per centroid for the
    kernel: tc is T's centroid part (:class:`Margin`), +inf for a centroid
    that is not finite or not below 2^50, which the kernel then always
    re-scores."""
    m = shortlist_margin(d)
    nc = torch.sqrt(cn)
    tc = m.tau * cn.abs() + m.abs_norm * nc + m.abs_const
    regular = torch.isfinite(cn) & (nc < _REGULAR_NORM)
    return torch.stack([cn, nc, torch.where(regular, tc, torch.inf), torch.zeros_like(cn)], 1)


def shortlist_stats():
    """``(rows, total, largest)`` of the last kernel launch: its rows, the
    (row, centroid) pairs it re-scored exactly, and the most for one row.
    Reads a device counter (synchronises); None before any launch."""
    if _LAST_SHORTLIST is None:
        return None
    n, stats = _LAST_SHORTLIST
    stats = stats.to(torch.int64)
    return n, int(stats[:, 0].sum()), int(stats[:, 1].max())


def _check(rows, cent, op: str):
    if rows.dim() != 2 or rows.dtype not in _DTYPES:
        raise ContractError(
            f"innr_tpu_torch::{op}: rows must be a 2-D float32, bfloat16 or uint8 "
            f"tensor, got {rows.dtype} of shape {tuple(rows.shape)}"
        )
    if cent.dim() != 2 or cent.shape[1] != rows.shape[1] or not 1 <= cent.shape[0] <= _MAX:
        raise ContractError(
            f"innr_tpu_torch::{op}: centroids must be (KC >= 1, {rows.shape[1]}), "
            f"got {tuple(cent.shape)}"
        )
    if cent.device != rows.device:
        raise ContractError(
            f"innr_tpu_torch::{op}: centroids on {cent.device}, rows on {rows.device}"
        )
    if rows.shape[0] > _MAX:
        raise ContractError(f"innr_tpu_torch::{op}: {rows.shape[0]} rows (< 2**31)")
    return rows.contiguous(), cent.to(torch.float32).contiguous()


def _cent_norms2(cent) -> torch.Tensor:
    """Squared centroid norms: one tensor, shared by kernel and plain version."""
    return (cent * cent).sum(dim=1)


def nearest_centroid_plain(rows, cent) -> torch.Tensor:
    """The plain version of the kernel: (N,) int32 nearest-centroid index,
    the largest composite of (bit-inverted total-order key of ``||c||^2 -
    2 x.c``, centroid), over row chunks (an (N, KC) score matrix at 10M x
    16,896 would be 676 GB)."""
    rows, cent = _check(rows, cent, "nearest_centroid_plain")
    n, kc = rows.shape[0], cent.shape[0]
    cn = _cent_norms2(cent)
    idx = torch.arange(kc, device=rows.device)
    nan = torch.tensor(0x7FC00000, dtype=torch.int32, device=rows.device).view(torch.float32)
    out = torch.empty(n, dtype=torch.int32, device=rows.device)
    step = max(1, _PLAIN_CHUNK // kc)
    for s in range(0, n, step):
        scores = cn[None, :] - 2.0 * (rows[s:s + step].float() @ cent.T)
        keys = ~total_order_key_f32(torch.where(torch.isnan(scores), nan, scores))
        out[s:s + step] = split_composite(composite_keys(keys, idx).max(dim=1).values)[1]
    return out


def _kernel(rows, cent) -> torch.Tensor:
    global LAUNCHES, _LAST_SHORTLIST
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n, d = rows.shape
    dev = rows.device
    with torch.cuda.device(dev):
        meta = _centroid_terms(_cent_norms2(cent), d)
        stats = torch.empty((-(-n // _ROW_TILE), 2), dtype=torch.int32, device=dev)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        rc = lib.innr_nearest_centroid(
            rows.data_ptr(), _DTYPES[rows.dtype], cent.data_ptr(), meta.data_ptr(),
            shortlist_margin(d).kappa, out.data_ptr(), stats.data_ptr(), n, d, cent.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"innr_tpu_torch: nearest_centroid launch failed, cudaError {rc}")
    _LAST_SHORTLIST = (n, stats)
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(rows.dtype).removeprefix("torch.")] += 1
    return out


def nearest_centroid(rows, cent) -> torch.Tensor:
    """``(N,) int32`` index of each row's nearest centroid (squared L2, ties
    to the lowest index). ``rows``: (N, D) float32, bfloat16 or uint8;
    ``cent``: (KC, D), used as float32."""
    rows, cent = _check(rows, cent, "nearest_centroid")
    dev = rows.device
    if dev.type == "cpu" or config.reference_forced():
        return nearest_centroid_plain(rows, cent)
    if dev.type != "cuda":
        raise ContractError(f"innr_tpu_torch::nearest_centroid: unsupported device {dev}")
    if rows.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    return _kernel(rows, cent)
