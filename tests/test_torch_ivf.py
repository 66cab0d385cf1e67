"""innr_tpu_torch.IVFIndex against the port's full scans and innr_tpu.IVFIndex.

k-means draws differ between ``jax.random`` and ``torch.Generator``, so the
layout is held to invariants (every cluster segment padded to a multiple of
the tile height, padding rows marked -1 and never returned, the real rows a
permutation of the corpus) and the searches to exact results: equal, bit
for bit, to the port's full scan of the original corpus, and to the JAX
index's indices with scores within cond_tol. The JAX index searches through
its static tile scan in interpret mode, as its own tests run it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.kernels import pruned_knn as tpk  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


EPS = float(np.finfo(np.float32).eps)
FULL = {"dot": tt.batch_knn_dot, "l2": tt.batch_knn, "cosine": tt.batch_knn_cosine}


@pytest.fixture
def corpus(rng):
    n, d, nc = 2400, 16, 8
    centers = 4.0 * rng.standard_normal((nc, d)).astype(np.float32)
    rows = (centers[rng.integers(0, nc, n)]
            + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    qs = (centers[[1, 5, 6]] + 0.02 * rng.standard_normal((3, d))).astype(np.float32)
    return rows, qs


def tols(qs, rows, metric):
    qs, rows = qs.astype(np.float64), rows.astype(np.float64)
    dot = 32 * EPS * (np.abs(qs) @ np.abs(rows).T).max(axis=1, keepdims=True)
    if metric == "dot":
        return dot
    if metric == "l2":
        return 32 * EPS * ((rows * rows).sum(1).max() + (qs * qs).sum(1, keepdims=True)) + 2 * dot
    return np.full((len(qs), 1), 1e-5)


def assert_topk_agrees(vals, idx, want_vals, want_idx, tol):
    v, w = np.asarray(vals, np.float64), np.asarray(want_vals, np.float64)
    assert (np.abs(v - w) <= tol).all(), (v, w)
    gaps = np.abs(np.diff(w, axis=1))
    inf = np.full((w.shape[0], 1), np.inf)
    sep = (np.concatenate([inf, gaps], 1) > 2 * tol) & (np.concatenate([gaps, inf], 1) > 2 * tol)
    np.testing.assert_array_equal(np.asarray(idx)[sep], np.asarray(want_idx)[sep])


class TestSearch:
    @pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
    def test_equals_full_scan_and_jax(self, corpus, metric):
        rows, qs = corpus
        index = tt.IVFIndex(rows, n_clusters=8, metric=metric, n_iters=3)
        got = index.search_batch(qs, 7)
        full = FULL[metric](qs, tt.VerticalBatch(rows), 7)
        np.testing.assert_array_equal(got.indices, full.indices)
        np.testing.assert_array_equal(got.scores, full.scores)
        want = it.IVFIndex(rows, n_clusters=8, metric=metric, n_iters=3).search_batch(qs, 7)
        assert_topk_agrees(got.scores, got.indices, want.scores, want.indices,
                           tols(qs, rows, metric))
        surv, total = index.plan_stats(qs, 7)
        assert 0 < surv < total == index._summary.n_tiles

    def test_bf16_storage(self, corpus):
        rows, qs = corpus
        index = tt.IVFIndex(rows, n_clusters=8, metric="dot", dtype=torch.bfloat16, n_iters=2)
        assert index.rows.dtype == torch.bfloat16
        got = index.search_batch(qs, 5)
        full = tt.batch_knn_dot(qs, tt.VerticalBatch(rows, dtype=torch.bfloat16), 5)
        np.testing.assert_array_equal(got.indices, full.indices)
        np.testing.assert_array_equal(got.scores, full.scores)
        per_row = 2 * 16 + 4 + 4  # bf16 row, orig_idx, the validity aux row
        assert index.memory_bytes() == (index.rows.shape[0] * per_row
                                        + index._summary.memory_bytes())

    def test_single_query_and_edges(self, corpus):
        rows, qs = corpus
        index = tt.IVFIndex(rows, n_clusters=8, metric="l2", n_iters=2)
        one = index.search(qs[2], 4)
        batch = index.search_batch(qs, 4)
        assert one.indices.shape == (4,)
        np.testing.assert_array_equal(one.indices, batch.indices[2])
        # The plain version's CPU matmul may sum a lone query in another order.
        assert (np.abs(one.scores - batch.scores[2]) <= tols(qs[2:], rows, "l2")[0]).all()
        assert index.search_batch(qs, 0).indices.shape == (3, 0)
        assert index.search_batch(qs, 10**6).indices.shape == (3, len(rows))
        with pytest.raises(ContractError):
            index.search_batch(np.zeros((2, 5), np.float32), 3)

    @pytest.mark.parametrize("metric,dtype", [("dot", torch.float32), ("l2", torch.float32),
                                              ("cosine", torch.float32),
                                              ("dot", torch.bfloat16)])
    def test_plan_stats_is_the_plan_the_search_reads(self, corpus, monkeypatch, metric, dtype):
        rows, qs = corpus
        index = tt.IVFIndex(rows, n_clusters=8, metric=metric, dtype=dtype, n_iters=2)
        seen = []
        real = tpk.pruned_keys

        def spy(qs_, rows_, aux, order, n_surv, *rest):
            seen.append(int(torch.as_tensor(n_surv).reshape(-1)[0]))
            return real(qs_, rows_, aux, order, n_surv, *rest)

        monkeypatch.setattr(tpk, "pruned_keys", spy)
        index.search_batch(qs, 5)
        assert seen == [index.plan_stats(qs, 5)[0]]

    def test_k_above_the_pass_cap(self, corpus, monkeypatch):
        rows, qs = corpus
        monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
        index = tt.IVFIndex(rows, n_clusters=8, metric="l2", n_iters=2)
        got = index.search_batch(qs, 40)
        full = tt.batch_knn(qs, tt.VerticalBatch(rows), 40)
        np.testing.assert_array_equal(got.indices, full.indices)
        np.testing.assert_array_equal(got.scores, full.scores)


class TestLayout:
    def test_aligned_padded_segments(self, corpus):
        rows, _ = corpus
        index = tt.IVFIndex(rows, n_clusters=8, metric="dot", n_iters=2)
        sizes = index.cluster_sizes
        tile = index.tile_n
        assert int(sizes.sum()) == len(rows) and tile % 128 == 0 and tile >= 256
        orig = index.orig_idx.numpy()
        valid = orig >= 0
        assert sorted(orig[valid].tolist()) == list(range(len(rows)))
        np.testing.assert_array_equal(index.rows.numpy()[valid], rows[orig[valid]])
        assert (index.rows.numpy()[~valid] == 0).all()
        padded = -(-sizes // tile) * tile
        assert index.rows.shape[0] == padded.sum()
        start = 0
        for size, seg in zip(sizes, padded):  # each segment: its rows, then padding
            assert valid[start:start + size].all() and not valid[start + size:start + seg].any()
            assert np.all(np.diff(orig[start:start + size]) > 0)  # corpus order
            start += seg
        assert index.padding_fraction == pytest.approx(1 - len(rows) / index.rows.shape[0])
        counts = index._summary.counts.numpy()
        assert counts.sum() == len(rows)

    def test_padding_rows_never_returned(self, rng):
        """Padding rows are zero: with every real row scoring below zero a
        zero row would win the dot search if it were not masked."""
        rows = -np.abs(rng.standard_normal((900, 8)).astype(np.float32)) - 1.0
        index = tt.IVFIndex(rows, n_clusters=3, metric="dot", tile_n=256, n_iters=2)
        assert index.padding_fraction > 0
        q = np.ones((2, 8), np.float32)
        got = index.search_batch(q, 900)
        assert (got.indices >= 0).all()
        np.testing.assert_array_equal(got.indices, tt.batch_knn_dot(q, tt.VerticalBatch(rows),
                                                                     900).indices)

    def test_explicit_tile_and_device(self, corpus):
        rows, qs = corpus
        index = tt.IVFIndex(torch.from_numpy(rows), n_clusters=4, tile_n=300, n_iters=1)
        assert index.tile_n == 300 and index.rows.device.type == "cpu"
        assert index.num_vectors == len(rows) and index.dimension == 16
        got = index.search_batch(jnp.asarray(qs), 3)
        np.testing.assert_array_equal(
            got.indices, tt.batch_knn_dot(qs, tt.VerticalBatch(rows), 3).indices)

    @pytest.mark.parametrize("kwargs", [dict(metric="hamming"), dict(dtype=torch.float16),
                                        dict(tile_n=0)])
    def test_contracts(self, corpus, kwargs):
        rows, _ = corpus
        with pytest.raises(ContractError):
            tt.IVFIndex(rows[:300], n_clusters=2, n_iters=1, **kwargs)

    def test_empty_corpus_raises(self):
        with pytest.raises(ContractError):
            tt.IVFIndex(np.zeros((0, 4), np.float32))
