"""The system under test: one of innr_tpu_torch's containers, built by set-up
from a configuration and the seed, and the one call every loop drives.

A configuration's ``index`` names its kind, ``gpubench/systems/<index>.py``
(found by :func:`gpubench.bench.system`), which defines:

- ``build(cfg, seed, devices, gen) -> search``: the container made from the
  seed with the generator ``gen``, and a callable that takes (Q, D) host
  queries and returns host ``(values, ids)``, k = the configuration's;
- ``blocks(cfg, seed, devices, gen) -> list``: the same corpus made again
  from the seed without the program, as the blocks its plain reference
  reads (:class:`gpubench.reference.Block` for the dense reference).

:meth:`System.call` records a :class:`Call` of each search on the host clock.
After the window, :meth:`System.free` drops the program's state, and
:func:`corpus_blocks` makes the corpus again for the reference.
"""

from __future__ import annotations

import gc
import time
from typing import NamedTuple

import numpy as np
import torch

from gpubench import bench


class Call(NamedTuple):
    start: float
    end: float
    n: int  # real queries (a bucket's pad rows are copies of its first)


def real_queries(qs: np.ndarray) -> int:
    """Queries of a MicroBatcher window without its pad rows, which repeat
    its first query at the end."""
    n = len(qs)
    while n > 1 and np.array_equal(qs[n - 1], qs[0]):
        n -= 1
    return n


class System:
    def __init__(self, cfg: dict, seed: int, devices: list, root=bench.ROOT):
        self.cfg, self.seed, self.devices = cfg, seed, devices
        self.k = cfg["k"]
        self.calls: list = []
        self.gen = bench.generator(cfg["generator"], root)
        self._search = bench.system(cfg["index"], root).build(cfg, seed, devices, self.gen)

    def call(self, qs: np.ndarray, k: int | None = None):
        """One search of (Q, D) host queries: host ``(values, ids)``.
        ``k`` is the configuration's (a MicroBatcher passes it)."""
        t = time.perf_counter()
        vals, ids = self._search(qs)
        self.calls.append(Call(t, time.perf_counter(), real_queries(qs)))
        return vals, ids

    def free(self) -> None:
        """Drops the container, which the search holds."""
        self._search = None
        gc.collect()
        for d in self.devices:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()


def corpus_blocks(cfg: dict, seed: int, devices: list, root=bench.ROOT) -> list:
    """The corpus as its reference's blocks, made from the seed without the
    program."""
    gen = bench.generator(cfg["generator"], root)
    return bench.system(cfg["index"], root).blocks(cfg, seed, devices, gen)


def deleted_ids(blocks) -> np.ndarray:
    """The global ids the blocks' alive masks mark deleted, sorted."""
    out = [torch.nonzero(~b.alive).flatten().cpu().numpy() + b.offset
           for b in blocks if getattr(b, "alive", None) is not None]
    return np.sort(np.concatenate(out)) if out else np.empty(0, np.int64)
