"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, each fault a cell can have planted in
the program at a tiny size."""

import numpy as np
import pytest
import torch
from conftest import tiny

import innr_tpu_torch as itt
from gpubench import bench
from gpubench.run import run


def _state_unchanged(monkeypatch):
    """Every search returns the first search's answers again."""
    orig, first = itt.batch_knn, []

    def stale(q, vb, k):
        r = orig(q, vb, k)
        if not first:
            first.append(r)
        rows = np.arange(len(r.indices)) % len(first[0].indices)
        return itt.BatchKnnResult(indices=first[0].indices[rows], scores=first[0].scores[rows])
    monkeypatch.setattr(itt, "batch_knn", stale)


def _half_the_batch(monkeypatch):
    """Only the first half of a batch is searched; the rest get its answers."""
    orig = itt.batch_knn

    def half(q, vb, k):
        q = np.asarray(q)
        h = max(1, (len(q) + 1) // 2)
        r = orig(q[:h], vb, k)
        rows = np.arange(len(q)) % h
        return itt.BatchKnnResult(indices=r.indices[rows], scores=r.scores[rows])
    monkeypatch.setattr(itt, "batch_knn", half)


def _answer_altered(monkeypatch):
    """One id of every answer is changed where the search produces it."""
    orig = itt.SegmentedCorpus.knn

    def altered(self, q, k):
        vals, ids = orig(self, q, k)
        ids = ids.copy()
        ids[..., -1] = (ids[..., -1] + 1) % self.num_vectors
        return vals, ids
    monkeypatch.setattr(itt.SegmentedCorpus, "knn", altered)


def _deletes_lost(monkeypatch):
    """Deletes are dropped: deleted rows come back."""
    monkeypatch.setattr(itt.SegmentedCorpus, "delete", lambda self, ids: 0)


FAULTS = [("deep100m.serve", _state_unchanged), ("deep100m.batch", _half_the_batch),
          ("msturing30m.seg.serve", _answer_altered),
          ("msturing30m.seg.serve", _deletes_lost)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    cell = tiny(bench.load_cell(name))
    fault(monkeypatch)
    out = run(cell, 23, 0.5, False, [torch.device("cpu")] * cell.chips)
    assert not out["result"]["correct"], out["checks"]
