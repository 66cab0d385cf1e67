"""innr_tpu_torch.ops.sparse against innr_tpu.ops.sparse: the sorted-index
dot, padding, SparseCorpus retrieval and the sparse MaxSim functions.

The same numpy data goes through both packages. N = 2100 takes innr_tpu's
fused kernel (interpret mode), N = 300 its XLA join; the port runs the
plain version of its CUDA kernel on CPU tensors. Indices span the full 32
bits. Integer-valued data: every score is exact, so scores and indices are
equal; Gaussian data: scores within cond_tol.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from conftest import cond_tol  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.utils.bits import unsigned_to_numpy  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def vocabulary(rng, size=48):
    """Sorted unique uint32 ids, half of them >= 2**31."""
    ids = np.concatenate([rng.choice(2**31, size // 2, replace=False),
                          rng.choice(2**31 - 1, size // 2, replace=False) + 2**31])
    return np.unique(ids.astype(np.uint32))


def sparse_vec(rng, vocab, nnz, integer=True):
    idx = np.sort(rng.choice(vocab, nnz, replace=False)).astype(np.uint32)
    val = rng.integers(-4, 5, nnz) if integer else rng.standard_normal(nnz)
    return idx, val.astype(np.float32)


def docs(rng, n, vocab, max_nnz=8, integer=True):
    return [sparse_vec(rng, vocab, int(rng.integers(1, max_nnz + 1)), integer)
            for _ in range(n)]


def same(got, want):
    """Port tensors against JAX arrays: float bits (any NaN as one NaN) or
    integers, exactly."""
    for g, w in zip(got, want, strict=True):
        g, w = g.numpy(), np.asarray(w)
        if w.dtype == np.float32:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_array_equal(g[~np.isnan(w)].view(np.int32),
                                          w[~np.isnan(w)].view(np.int32))
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


class TestSparseDot:
    @pytest.mark.parametrize("trial", range(4))
    def test_integer_exact(self, rng, trial):
        vocab = vocabulary(rng)
        a, b = sparse_vec(rng, vocab, 20), sparse_vec(rng, vocab, 30)
        got = itt.sparse_dot(*a, *b)
        assert got.dtype == torch.float32 and got.dim() == 0
        same((got,), (it.sparse_dot(*a, *b),))

    def test_gaussian_within_cond_tol(self, rng):
        vocab = vocabulary(rng, 64)
        a, b = sparse_vec(rng, vocab, 40, False), sparse_vec(rng, vocab, 40, False)
        want = float(it.sparse_dot(*a, *b))
        assert float(itt.sparse_dot(*a, *b)) == pytest.approx(want, abs=cond_tol(a[1], a[1]))

    def test_duplicates_empty_and_errors(self):
        bi = np.array([2, 2**31 + 5, 2**31 + 5], np.uint32)  # duplicate: first wins
        bv = np.array([1.0, 10.0, 100.0], np.float32)
        ai = np.array([2**31 + 5], np.uint32)
        assert float(itt.sparse_dot(ai, [2.0], bi, bv)) == float(
            it.sparse_dot(ai, [2.0], bi, bv)) == 20.0
        e, ev = np.zeros(0, np.uint32), np.zeros(0, np.float32)
        assert float(itt.sparse_dot(e, ev, bi, bv)) == 0.0
        with pytest.raises(itt.ContractError, match="length mismatch"):
            itt.sparse_dot([0, 1], [1.0], [0], [1.0])


class TestPadding:
    def test_pad_sparse(self, rng):
        tokens = docs(rng, 5, vocabulary(rng))
        for width in (None, 12):
            ti, tv = itt.pad_sparse(tokens, width)
            ji, jv = it.pad_sparse(tokens, width)
            np.testing.assert_array_equal(unsigned_to_numpy(ti), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert tuple(itt.pad_sparse([])[0].shape) == np.asarray(it.pad_sparse([])[0]).shape
        with pytest.raises(itt.ContractError, match="width"):
            itt.pad_sparse(tokens, 0 if max(len(i) for i, _ in tokens) > 1 else -1)

    def test_pad_sparse_docs(self, rng):
        vocab = vocabulary(rng)
        corpus = [docs(rng, int(rng.integers(1, 4)), vocab) for _ in range(4)] + [[]]
        for kw in ({}, dict(width=10, tokens=5)):
            got = itt.pad_sparse_docs(corpus, **kw)
            want = it.pad_sparse_docs(corpus, **kw)
            np.testing.assert_array_equal(unsigned_to_numpy(got[0]), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        with pytest.raises(itt.ContractError, match="tokens"):
            itt.pad_sparse_docs(corpus, tokens=1)


class TestSparseCorpus:
    def test_container(self, rng):
        d = docs(rng, 30, vocabulary(rng))
        jc, tc = it.SparseCorpus(d), itt.SparseCorpus(d)
        assert (tc.num_docs, tc.width) == (jc.num_docs, jc.width)
        assert tc.memory_bytes() == jc.memory_bytes()
        np.testing.assert_array_equal(unsigned_to_numpy(tc.indices), np.asarray(jc.indices))
        idx_t, val_t = tc._transposed()
        assert idx_t.is_contiguous() and torch.equal(idx_t, tc.indices.T)
        assert tc._transposed()[0] is idx_t  # cached
        assert tc._all_finite() == jc._all_finite()
        padded = itt.SparseCorpus((unsigned_to_numpy(tc.indices), tc.values.numpy()))
        assert torch.equal(padded.indices, tc.indices)
        two = itt.SparseCorpus(tuple(d[:2]))  # a tuple of two documents, not a pair
        assert two.num_docs == 2
        with pytest.raises(itt.ContractError, match="matching 2-D"):
            itt.SparseCorpus((np.zeros((3, 2), np.uint32), np.zeros((3, 4), np.float32)))


N_CASES = [2100, 300]  # innr_tpu's fused kernel / its XLA join


class TestKnnAgainstJax:
    @pytest.mark.parametrize("n", N_CASES)
    def test_sparse_knn_integer_exact(self, rng, n):
        vocab = vocabulary(rng)
        d = docs(rng, n, vocab)
        d[7] = (np.full(3, 0xFFFFFFFF, np.uint32), np.zeros(3, np.float32))  # empty doc
        jc, tc = it.SparseCorpus(d), itt.SparseCorpus(d)
        for lq in (1, 6, 20):
            q = sparse_vec(rng, vocab, lq)
            got = itt.sparse_knn(q, tc, 9)
            assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
            same(got, it.sparse_knn(q, jc, 9))
            same(tc.knn(q, 9), jc.knn(q, 9))

    @pytest.mark.parametrize("n", N_CASES)
    def test_sparse_knn_batch_equals_per_query(self, rng, n):
        vocab = vocabulary(rng)
        d = docs(rng, n, vocab)
        jc, tc = it.SparseCorpus(d), itt.SparseCorpus(d)
        queries = [sparse_vec(rng, vocab, lq) for lq in (3, 1, 8)]
        got = itt.sparse_knn_batch(queries, tc, 6)
        same(got, it.sparse_knn_batch(queries, jc, 6))
        for j, q in enumerate(queries):
            s1, i1 = itt.sparse_knn(q, tc, 6)
            assert torch.equal(i1, got[1][j])
        padded = it.pad_sparse(queries)
        same(itt.sparse_knn_batch(tuple(np.asarray(a) for a in padded), tc, 6), got)
        same(tc.knn_batch(queries, 6), jc.knn_batch(queries, 6))

    def test_nan_matched_and_unmatched(self, rng):
        vocab = vocabulary(rng, 16)
        d = docs(rng, 2100, vocab)
        q = sparse_vec(rng, vocab, 5)
        q[1][:] = np.where(q[1] == 0, 1.0, q[1])
        miss = np.setdiff1d(vocab, q[0])[0]
        d[3] = (np.sort(np.array([q[0][2], miss], np.uint32)), np.array([np.nan, np.nan]))
        d[4] = (np.array([miss], np.uint32), np.array([np.nan], np.float32))
        jc, tc = it.SparseCorpus(d), itt.SparseCorpus(d)
        got = itt.sparse_knn(q, tc, 2100)
        same(got, it.sparse_knn(q, jc, 2100))
        assert got[1][0] == 3 and np.isnan(got[0][0])
        assert float(got[0][got[1] == 4]) == 0.0

    def test_gaussian_within_cond_tol(self, rng):
        vocab = vocabulary(rng, 24)
        d = docs(rng, 2100, vocab, integer=False)
        q = sparse_vec(rng, vocab, 10, integer=False)
        gs, _ = itt.sparse_knn(q, itt.SparseCorpus(d), 8)
        js, _ = it.sparse_knn(q, it.SparseCorpus(d), 8)
        tol = 32 * np.finfo(np.float32).eps * 8 * 4 * np.abs(q[1]).max()
        np.testing.assert_allclose(gs.numpy(), np.asarray(js), rtol=0, atol=tol)

    @pytest.mark.parametrize("k", [0, -2, 5000])
    def test_k_edges_and_empty_queries(self, rng, k):
        vocab = vocabulary(rng)
        d = docs(rng, 300, vocab)
        jc, tc = it.SparseCorpus(d), itt.SparseCorpus(d)
        q = sparse_vec(rng, vocab, 4)
        for got, want in ((itt.sparse_knn(q, tc, k), it.sparse_knn(q, jc, k)),
                          (itt.sparse_knn_batch([q, q], tc, k), it.sparse_knn_batch([q, q], jc, k))):
            assert tuple(got[0].shape) == np.asarray(want[0]).shape
            same(got, want)
        empty = (np.zeros(0, np.uint32), np.zeros(0, np.float32))
        same(itt.sparse_knn(empty, tc, 5), it.sparse_knn(empty, jc, 5))
        assert tuple(itt.sparse_knn_batch([], tc, 3)[0].shape) == (0, 3)

    def test_query_errors(self, rng):
        tc = itt.SparseCorpus(docs(rng, 20, vocabulary(rng)))
        with pytest.raises(itt.ContractError, match="pair"):
            itt.sparse_knn((np.array([1], np.uint32),), tc, 3)
        with pytest.raises(itt.ContractError, match="length mismatch"):
            itt.sparse_knn((np.array([1, 2], np.uint32), np.array([1.0], np.float32)), tc, 3)


class TestUnsortedQuery:
    """ROADMAP F1: a query whose ids are not sorted. The JAX kernel path
    (N >= 2048) sweeps the query in any order, and on a duplicate id the
    first occurrence wins; the port sorts each query stably, as unsigned,
    and must give the kernel path's scores and indices exactly, through
    sparse_knn and through each row of sparse_knn_batch."""

    N = 2048

    def kernel_path(self, q, corpus, k):
        from innr_tpu.kernels.sparse_knn import fused_sparse_knn

        return fused_sparse_knn(np.asarray(q[0], np.uint32), np.asarray(q[1], np.float32),
                                *corpus._transposed(), k)

    def check(self, docs_, queries, k):
        jc, tc = it.SparseCorpus(docs_), itt.SparseCorpus(docs_)
        batch = itt.sparse_knn_batch(queries, tc, k)
        for j, q in enumerate(queries):
            want = self.kernel_path(q, jc, k)
            same(itt.sparse_knn(q, tc, k), want)
            same((batch[0][j], batch[1][j]), want)
        return batch

    def test_roadmap_input(self):
        d = [(np.array([4, 9], np.uint32), np.array([1.0, i % 3], np.float32))
             for i in range(self.N)]
        q = (np.array([9, 4], np.uint32), np.array([1.0, 2.0], np.float32))
        scores, idx = self.check(d, [q], 3)
        assert scores[0].tolist() == [4.0, 4.0, 4.0] and idx[0].tolist() == [2, 5, 8]

    def test_duplicate_ids_first_occurrence_wins(self, rng):
        vocab = vocabulary(rng, 16)
        d = docs(rng, self.N, vocab)
        hi, lo = vocab[-1], vocab[0]  # hi >= 2**31: unsigned order puts it last
        dup = (np.array([hi, lo, hi, lo], np.uint32), np.array([3.0, -2.0, 7.0, 5.0], np.float32))
        perm = rng.permutation(vocab)[:6]
        shuffled = (perm.astype(np.uint32), rng.integers(-4, 5, 6).astype(np.float32))
        self.check(d, [dup, shuffled, sparse_vec(rng, vocab, 5)], 7)


class TestSparseMaxSim:
    def _doc(self, rng, vocab, n_tokens, integer=True):
        return docs(rng, n_tokens, vocab, max_nnz=6, integer=integer)

    def test_pairwise(self, rng):
        vocab = vocabulary(rng, 24)
        q, d = self._doc(rng, vocab, 3), self._doc(rng, vocab, 4)
        same((itt.sparse_maxsim(q, d),), (it.sparse_maxsim(q, d),))
        same((itt.sparse_maxsim(itt.pad_sparse(q), d),), (it.sparse_maxsim(it.pad_sparse(q), d),))
        assert float(itt.sparse_maxsim([], d)) == float(itt.sparse_maxsim(q, [])) == 0.0

    @pytest.mark.parametrize("integer", [True, False])
    def test_batch_and_knn(self, rng, integer):
        vocab = vocabulary(rng, 24)
        corpus = [self._doc(rng, vocab, int(rng.integers(1, 5)), integer) for _ in range(40)]
        corpus[5] = []
        q = self._doc(rng, vocab, 3, integer)

        def check(got, want):  # exact on integers, else within 32 eps of the sums
            if integer:
                same((got,), (want,))
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

        got = itt.sparse_maxsim_batch(q, corpus)
        check(got, it.sparse_maxsim_batch(q, corpus))
        if integer:
            same(itt.sparse_maxsim_knn(q, corpus, 7), it.sparse_maxsim_knn(q, corpus, 7))
        assert float(got[5]) == 0.0
        triple = itt.pad_sparse_docs(corpus)
        assert torch.equal(itt.sparse_maxsim_batch(q, triple), got)
        one = q[0]  # a single 1-D pair is one token
        check(itt.sparse_maxsim_batch(one, corpus), it.sparse_maxsim_batch(one, corpus))

    def test_negative_overlaps_and_empty(self, rng):
        neg = [(np.array([2**31 + 1], np.uint32), np.array([-5.0], np.float32))]
        two = neg + [(np.array([2**31 + 1], np.uint32), np.array([-7.0], np.float32))]
        pos_q = [(np.array([2**31 + 1], np.uint32), np.array([1.0], np.float32))]
        np.testing.assert_array_equal(itt.sparse_maxsim_batch(pos_q, [neg, two]).numpy(),
                                      [-5.0, -5.0])
        assert itt.sparse_maxsim_batch([], [neg]).tolist() == [0.0]
        s, i = itt.sparse_maxsim_knn(pos_q, [], 3)
        assert s.shape == (0,) and i.shape == (0,)
        with pytest.raises(itt.ContractError, match="matching"):
            itt.sparse_maxsim_batch((np.array([1], np.uint32), np.array([1.0, 2.0])), [neg])
