"""Multi-process initialisation and corpus construction on torch.distributed.

The counterpart of :mod:`innr_tpu.parallel.multihost`. The rest of this
package is single-controller (one process drives every device of its
mesh); this module is where processes come in. Each process holds one
block of the corpus's rows, sharded over its own devices, and a search
merges twice: each process's shards on its first device, then the
processes' (Q, k) candidate lists, gathered by one ``all_gather`` over the
process group, so that every rank gets the same answer. The backend is
NCCL when the default device is a card and gloo on the CPU; nothing
switches one for the other.

Deployment recipe for a corpus over N processes:

1. every process calls :func:`initialize` (explicit arguments, or the
   ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``
   environment variables of ``torch.distributed``);
2. each process loads ONLY its own rows (no process ever holds the whole
   corpus) and calls :func:`corpus_from_process_local_rows`;
3. every process runs the same queries with the same k, as on one host.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from innr_tpu_torch import config
from innr_tpu_torch.parallel.sharded import Mesh, ShardedCorpus
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import composite_keys, merge_parts, split_composite

__all__ = [
    "initialize",
    "is_multiprocess",
    "corpus_from_process_local_rows",
]

_EMPTY = torch.iinfo(torch.int64).min


def _backend() -> str:
    return "nccl" if config.default_device().type == "cuda" else "gloo"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None) -> None:
    """Start the process group (idempotent).

    ``coordinator_address``: ``host:port`` (a TCP rendezvous) or an init
    method URL (``tcp://...``, ``file://...``); without it,
    ``MASTER_ADDR`` (with ``MASTER_PORT``) selects the ``env://``
    rendezvous. ``num_processes`` / ``process_id`` default to
    ``WORLD_SIZE`` / ``RANK``. ``local_device_ids``: this process's cards;
    the first becomes its current device. A no-op when a group is already
    up or when nothing is configured (one process)."""
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = "env://"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return  # one process: nothing to do
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ContractError(
            "multihost.initialize: need a coordinator address, the process count and this "
            "process's id (arguments or MASTER_ADDR / WORLD_SIZE / RANK)")
    backend = _backend()
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: the default device is a card, but no "
                               "CUDA device is available")
        if local_device_ids:
            torch.cuda.set_device(int(list(local_device_ids)[0]))
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))


def is_multiprocess() -> bool:
    """True when a process group of more than one process is up."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _rank_world() -> tuple[int, int]:
    return (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)


class _ProcessCorpus(ShardedCorpus):
    """This process's block of a corpus spread over a process group: its
    shards carry global row ranges, and :meth:`_across` merges the
    processes' candidate lists (through the group whenever one is up, a
    one-process group included)."""

    def _across(self, keys, idx, k: int):
        if not dist.is_initialized():
            return keys, idx
        world = dist.get_world_size()
        comp = composite_keys(keys, idx)
        if comp.shape[1] < k:  # empty slots lose to every K1 key of a row
            pad = torch.full((comp.shape[0], k - comp.shape[1]), _EMPTY, dtype=torch.int64,
                             device=comp.device)
            comp = torch.cat([comp, pad], dim=1)
        wire = comp.to(_wire_device(), non_blocking=True)
        got = [torch.empty_like(wire) for _ in range(world)]
        dist.all_gather(got, wire)
        return merge_parts([split_composite(torch.cat(got, dim=1).to(keys.device))], k,
                           keys.device)


def _wire_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    for NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _block_heights(n_local: int) -> list:
    if not dist.is_initialized():
        return [n_local]
    world = dist.get_world_size()
    t = torch.tensor([n_local], dtype=torch.int64, device=_wire_device())
    got = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(got, t)
    return [int(g.item()) for g in got]


def corpus_from_process_local_rows(local_rows, n_total: int | None = None,
                                   mesh: Mesh | None = None) -> ShardedCorpus:
    """A corpus spread over the process group, built from per-process row
    blocks without any process holding the whole corpus.

    ``local_rows``: this process's contiguous block of the global corpus,
    in process order (process 0 holds rows ``[0, n0)``, process 1 ``[n0,
    n0 + n1)``, ...); it is sharded over ``mesh`` (default: this process's
    visible cards, or the default device). The blocks' offsets come from
    one ``all_gather`` of their heights. Every process must pass the same
    ``n_total`` (default ``process count x local rows``, which needs equal
    blocks); it must equal the sum of the heights. Searches return global
    indices, the same on every rank."""
    if not isinstance(local_rows, torch.Tensor):
        local_rows = np.asarray(local_rows, dtype=np.float32)
    if local_rows.ndim != 2:
        raise ContractError("corpus_from_process_local_rows: local_rows must be 2-D")
    rank, world = _rank_world()
    n_local = int(local_rows.shape[0])
    if n_total is None:
        n_total = world * n_local
    heights = _block_heights(n_local)
    if sum(heights) != int(n_total):
        raise ContractError(
            f"corpus_from_process_local_rows: the blocks hold {sum(heights)} rows, "
            f"n_total is {n_total}")
    corpus = _ProcessCorpus(local_rows, mesh)
    offset = sum(heights[:rank])
    corpus.ranges = [(s + offset, e + offset) for s, e in corpus.ranges]
    corpus.n_true = int(n_total)
    return corpus
