"""innr_tpu_torch.TopK against innr_tpu.TopK over the same candidate streams:
ties (equal distances keep insertion order), NaN (sorts greatest, never
accepted over a number), -NaN and -0.0, eviction and the threshold."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402


def stream(rng, n, with_specials=True):
    d = rng.integers(0, 8, n).astype(np.float32)  # many ties
    if with_specials:
        d[rng.choice(n, 6, replace=False)] = [np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0]
    return np.arange(n, dtype=np.uint32) * 7 + 3, d


def drain(cls, k, ids, dists, batch):
    top = cls(k)
    if batch:
        top.insert_batch(ids, dists)
    else:
        for i, d in zip(ids, dists):
            top.insert(int(i), float(d))
    return top


def same(a, b):
    """Sorted results equal: ids, and distances bit for bit."""
    assert [i for i, _ in a] == [i for i, _ in b]
    bits = [np.float32(d).view(np.int32) for _, d in a]
    assert bits == [np.float32(d).view(np.int32) for _, d in b]


class TestAgainstJax:
    @pytest.mark.parametrize("k", [1, 3, 10, 64])
    @pytest.mark.parametrize("batch", [False, True])
    def test_streams_with_ties_and_nan(self, rng, k, batch):
        ids, dists = stream(rng, 200)
        got = drain(itt.TopK, k, ids, dists, batch)
        want = drain(it.TopK, k, ids, dists, batch)
        assert len(got) == len(want) and got.threshold() == want.threshold() or (
            math.isnan(got.threshold()) and math.isnan(want.threshold()))
        same(got.into_sorted(), want.into_sorted())

    def test_fewer_candidates_than_k(self, rng):
        ids, dists = stream(rng, 5, with_specials=False)
        got, want = drain(itt.TopK, 9, ids, dists, True), drain(it.TopK, 9, ids, dists, True)
        assert got.threshold() == math.inf and len(got) == 5
        same(got.into_sorted(), want.into_sorted())


class TestSemantics:
    def test_basic_and_consumed(self):
        top = itt.TopK(3)
        for i, d in [(0, 1.5), (1, 0.3), (2, 2.0), (3, 0.8)]:
            top.insert(i, d)
        assert [r[0] for r in top.into_sorted()] == [1, 3, 0]
        assert top.is_empty() and len(top) == 0

    def test_k_must_be_positive(self):
        for k in (0, -1):
            with pytest.raises(ValueError):
                itt.TopK(k)

    def test_nan_does_not_poison(self):
        top = itt.TopK(2)
        for i, d in [(0, float("nan")), (1, 1.0), (2, 0.5)]:
            top.insert(i, d)
        assert {i for i, _ in top.into_sorted()} == {1, 2}

    def test_equal_distances_keep_insertion_order(self):
        top = itt.TopK(3)
        for i in range(5):
            top.insert(i, 1.0)
        assert [i for i, _ in top.into_sorted()] == [0, 1, 2]

    def test_insert_batch_length_mismatch_raises(self):
        with pytest.raises(ValueError):
            itt.TopK(2).insert_batch([1, 2], [1.0])
