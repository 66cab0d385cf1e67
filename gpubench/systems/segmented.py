"""``index: segmented``: a ``SegmentedCorpus`` built through ``add``, one
segment of ``rows / segments`` rows at a time, then ``delete``, one step a
cluster (the generator's ``deletions``); searched by ``knn`` (L2) or
``knn_dot`` (ip). Its reference blocks carry the alive mask that the
benchmark's own deletions give."""

import numpy as np
import torch

import innr_tpu_torch as itt
from gpubench.reference import Block


def build(cfg, seed, devices, gen):
    dev = devices[0]
    n, n_seg = cfg["rows"], cfg["segments"]
    if n % n_seg:
        raise ValueError("segmented: rows must be a multiple of segments")
    sc = itt.SegmentedCorpus(cfg["dim"], auto_compact=False, device=dev)
    step = n // n_seg
    for s in range(0, n, step):
        got = sc.add(gen.rows(cfg, seed, s, s + step, dev))
        if got != (s, s + step):
            raise RuntimeError(f"segmented: add gave ids {got}, expected {(s, s + step)}")
    for ids in gen.deletions(cfg, seed):
        sc.delete(ids)
    fn = sc.knn if cfg["metric"] == "l2" else sc.knn_dot
    k = cfg["k"]
    return lambda qs: fn(qs, k)


def blocks(cfg, seed, devices, gen):
    n = cfg["rows"]
    rows = gen.rows(cfg, seed, 0, n, devices[0])
    alive = np.ones(n, bool)
    alive[np.concatenate(gen.deletions(cfg, seed))] = False
    return [Block(rows, 0, torch.from_numpy(alive).to(rows.device))]
