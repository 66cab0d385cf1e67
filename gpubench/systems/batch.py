"""``index: batch``: a ``VerticalBatch`` over the generated rows (the tensor
itself, no copy), searched by ``batch_knn`` (L2) or ``batch_knn_dot`` (ip)."""

import innr_tpu_torch as itt
from gpubench.reference import Block


def build(cfg, seed, devices, gen):
    vb = itt.VerticalBatch(gen.rows(cfg, seed, 0, cfg["rows"], devices[0]))
    fn = itt.batch_knn if cfg["metric"] == "l2" else itt.batch_knn_dot
    k = cfg["k"]

    def search(qs):
        r = fn(qs, vb, k)
        return r.scores, r.indices
    return search


def blocks(cfg, seed, devices, gen):
    return [Block(gen.rows(cfg, seed, 0, cfg["rows"], devices[0]), 0)]
