"""Nearest-centroid assignment: the CUDA kernel and its plain version.

Replaces the TPU kernel ``innr_tpu/kernels/assign.py:_nearest_kernel``
(launched by ``nearest_centroid``), the full-corpus pass of the k-means
behind :func:`innr_tpu_torch.prune.cluster_reorder` and
:class:`innr_tpu_torch.ivf.IVFIndex`. The kernel is ``csrc/assign.cu``; its
source note says what bounds it on the H100.

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

import torch

from innr_tpu_torch import config
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import composite_keys, split_composite, total_order_key_f32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_MAX = 2**31 - 1
# Elements of the (rows, KC) score block the plain version holds at a time.
_PLAIN_CHUNK = 1 << 25

# Kernel launches, in all and by row dtype. Incremented only where the
# kernel launches.
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0, "uint8": 0}


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
    global LAUNCHES
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n, d = rows.shape
    dev = rows.device
    with torch.cuda.device(dev):
        cn = _cent_norms2(cent)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        rc = lib.innr_nearest_centroid(
            rows.data_ptr(), _DTYPES[rows.dtype], cent.data_ptr(), cn.data_ptr(),
            out.data_ptr(), n, d, cent.shape[0], torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"innr_tpu_torch: nearest_centroid launch failed, cudaError {rc}")
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
