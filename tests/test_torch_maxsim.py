"""innr_tpu_torch.ops.maxsim against innr_tpu.ops.maxsim.

The same numpy tokens go through both packages. ``maxsim``,
``maxsim_cosine`` and ``batch_maxsim`` are one product and two reductions
in both; ``maxsim_knn`` / ``maxsim_knn_batch`` are held to the JAX
package's kernel path (N >= 128 documents, its ``MIN_ROWS_PALLAS // 16``
gate), since the port takes the kernel's function at every size. Scores
within cond_tol (32 eps of the sum of |products|) on Gaussian tokens and
bit for bit on integer-valued ones; indices equal where the ranking
separates them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import maxsim_kernel as tmk  # noqa: E402
from innr_tpu_torch.ops import maxsim as tms  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


EPS = float(np.finfo(np.float32).eps)


def tol_pair(q, d):
    """32 eps sum_i max_j sum_d |q_id d_jd|: cond_tol of one MaxSim score."""
    return 32 * EPS * float((np.abs(q).astype(np.float64) @ np.abs(d).T.astype(np.float64))
                            .max(axis=1).sum())


class TestMaxsim:
    def test_docstring_case(self):
        q = [[1.0, 0.0], [0.0, 1.0]]
        d = [[0.9, 0.1], [0.1, 0.9], [0.5, 0.5]]
        assert float(itt.maxsim(q, d)) == pytest.approx(float(it.maxsim(q, d)), abs=1e-6)

    @pytest.mark.parametrize("fn", ["maxsim", "maxsim_cosine"])
    def test_empty_is_zero(self, fn):
        f = getattr(itt, fn)
        for a, b in (([], [[1.0, 2.0]]), ([[1.0, 2.0]], []), (np.zeros((0, 3)), np.ones((2, 3)))):
            got = f(a, b)
            assert isinstance(got, torch.Tensor) and float(got) == 0.0
            assert float(getattr(it, fn)(a, b)) == 0.0

    @pytest.mark.parametrize("fn", ["maxsim", "maxsim_cosine"])
    @pytest.mark.parametrize("q,d", [([[1.0, 2.0], [1.0]], [[1.0, 2.0]]),
                                     ([[1.0, 2.0]], [[1.0, 2.0, 3.0]]),
                                     (np.ones((2, 2, 2)), np.ones((2, 2)))])
    def test_ragged_or_dimension_mismatch_raises(self, fn, q, d):
        with pytest.raises(itt.ContractError):
            getattr(itt, fn)(q, d)
        with pytest.raises(it.ContractError):
            getattr(it, fn)(q, d)

    def test_not_commutative(self, rng):
        q = rng.standard_normal((2, 16)).astype(np.float32)
        d = rng.standard_normal((5, 16)).astype(np.float32)
        assert float(itt.maxsim(q, d)) != pytest.approx(float(itt.maxsim(d, q)), abs=1e-6)
        assert float(itt.maxsim(d, q)) == pytest.approx(float(it.maxsim(d, q)),
                                                        abs=tol_pair(d, q))

    def test_additivity_over_query_tokens(self, rng):
        q = rng.standard_normal((3, 16)).astype(np.float32)
        d = rng.standard_normal((5, 16)).astype(np.float32)
        parts = sum(float(itt.maxsim(q[i:i + 1], d)) for i in range(3))
        assert float(itt.maxsim(q, d)) == pytest.approx(parts, abs=tol_pair(q, d))

    @pytest.mark.parametrize("shape", [(1, 1, 4), (3, 5, 16), (8, 2, 128), (2, 9, 65)])
    def test_against_jax(self, rng, shape):
        tq, td, dim = shape
        q = rng.standard_normal((tq, dim)).astype(np.float32)
        d = rng.standard_normal((td, dim)).astype(np.float32)
        assert float(itt.maxsim(q, d)) == pytest.approx(float(it.maxsim(q, d)),
                                                        abs=tol_pair(q, d))
        assert float(itt.maxsim_cosine(q, d)) == pytest.approx(float(it.maxsim_cosine(q, d)),
                                                               abs=32 * EPS * tq)

    def test_cosine_zero_norm_token_scores_zero(self, rng):
        q = np.zeros((1, 8), np.float32)
        d = rng.standard_normal((3, 8)).astype(np.float32)
        assert float(itt.maxsim_cosine(q, d)) == 0.0
        d[1] = np.nan  # a NaN-norm row is pinned to zero, too
        q = rng.standard_normal((2, 8)).astype(np.float32)
        assert float(itt.maxsim_cosine(q, d)) == pytest.approx(float(it.maxsim_cosine(q, d)),
                                                               abs=1e-5)

    def test_tensor_input_is_cast_to_float32(self):
        got = itt.maxsim(torch.ones(2, 3, dtype=torch.float64), np.ones((4, 3)))
        assert got.dtype == torch.float32 and float(got) == 6.0


class TestBatchMaxsim:
    def test_against_jax_and_pairwise(self, rng):
        queries = rng.standard_normal((3, 4, 16)).astype(np.float32)
        docs = rng.standard_normal((5, 6, 16)).astype(np.float32)
        got = itt.batch_maxsim(queries, docs).numpy()
        want = np.asarray(it.batch_maxsim(queries, docs))
        assert got.shape == (3, 5)
        for qi in range(3):
            for ni in range(5):
                tol = tol_pair(queries[qi], docs[ni])
                assert got[qi, ni] == pytest.approx(want[qi, ni], abs=tol)
                assert got[qi, ni] == pytest.approx(float(itt.maxsim(queries[qi], docs[ni])),
                                                    abs=tol)

    def test_masks_against_jax(self, rng):
        q = rng.integers(-3, 4, (2, 4, 8)).astype(np.float32)
        docs = rng.integers(-4, 5, (6, 5, 8)).astype(np.float32)
        docs[1, 4] = 100.0
        doc_mask = np.ones((6, 5), bool)
        doc_mask[1, 4] = False
        doc_mask[3] = False  # fully masked: 0.0
        query_mask = np.array([[True, True, False, False], [True, True, True, True]])
        got = itt.batch_maxsim(q, docs, doc_mask=doc_mask, query_mask=query_mask).numpy()
        want = np.asarray(it.batch_maxsim(q, docs, doc_mask=doc_mask, query_mask=query_mask))
        np.testing.assert_array_equal(got, want)
        assert (got[:, 3] == 0.0).all()

    def test_no_doc_mask_keeps_minus_inf(self):
        """Without a doc_mask neither package clamps a -inf best."""
        q = np.ones((1, 1, 2), np.float32)
        docs = np.array([[[-np.inf, 0.0]]], np.float32)
        assert itt.batch_maxsim(q, docs).tolist() == [[-np.inf]]
        assert np.asarray(it.batch_maxsim(q, docs)).tolist() == [[-np.inf]]


def jax_kernel_path(fn, *args, **kw):
    vals, idx = fn(*args, **kw)
    return np.asarray(vals), np.asarray(idx)


def assert_knn_close(got, want, tol):
    """Scores within ``tol``, indices equal where the ranking separates."""
    gv, gi = (t.numpy() for t in got)
    wv, wi = want
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    gaps = np.abs(np.diff(wv, axis=-1))
    sep = np.minimum(np.concatenate([np.full(wv.shape[:-1] + (1,), np.inf), gaps], -1),
                     np.concatenate([gaps, np.full(wv.shape[:-1] + (1,), np.inf)], -1)) > 2 * tol
    np.testing.assert_array_equal(gi[sep], wi[sep])


class TestMaxsimKnn:
    def test_against_jax_kernel_path(self, rng):
        q = rng.standard_normal((4, 16)).astype(np.float32)
        docs = rng.standard_normal((200, 6, 16)).astype(np.float32)
        docs[17, :4] = q  # the query's own tokens: doc 17 first
        mask = rng.random((200, 6)) < 0.8
        mask[17, :4] = True
        got = itt.maxsim_knn(q, docs, 8, doc_mask=mask)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        assert int(got[1][0]) == 17
        tol = 32 * EPS * float(np.abs(q).sum() * np.abs(docs).max())
        assert_knn_close(got, jax_kernel_path(it.maxsim_knn, q, docs, 8, doc_mask=mask), tol)

    def test_integer_valued_exact_with_ties(self, rng):
        q = rng.integers(-3, 4, (3, 8)).astype(np.float32)
        docs = rng.integers(-4, 5, (160, 5, 8)).astype(np.float32)
        docs[[50, 120]] = docs[9]
        vals, idx = itt.maxsim_knn(q, docs, 160)
        wv, wi = jax_kernel_path(it.maxsim_knn, q, docs, 160)
        np.testing.assert_array_equal(vals.numpy().view(np.int32), wv.view(np.int32))
        np.testing.assert_array_equal(idx.numpy(), wi)

    def test_batch_against_jax_kernel_path(self, rng):
        qs = rng.standard_normal((3, 5, 16)).astype(np.float32)
        docs = rng.standard_normal((150, 8, 16)).astype(np.float32)
        mask = rng.random((150, 8)) > 0.25
        mask[:, 0] = True
        got = itt.maxsim_knn_batch(qs, docs, 6, doc_mask=mask)
        assert tuple(got[0].shape) == (3, 6) and got[1].dtype == torch.int32
        tol = 32 * EPS * float(np.abs(qs).sum(2).max() * np.abs(docs).max())
        assert_knn_close(got, jax_kernel_path(it.maxsim_knn_batch, qs, docs, 6, doc_mask=mask),
                         tol)
        for b in range(3):
            one = itt.maxsim_knn(qs[b], docs, 6, doc_mask=mask)
            assert torch.equal(one[1], got[1][b])

    def test_batch_r7_query_keeps_its_inf(self, rng):
        """An inf in query 1 leaves query 0's neighbours as they are alone
        (the JAX kernel path spreads it to every query: ROADMAP R7)."""
        qs = rng.standard_normal((3, 4, 8)).astype(np.float32)
        docs = rng.standard_normal((140, 5, 8)).astype(np.float32)
        qs[1, 0, 0] = np.inf
        vals, idx = itt.maxsim_knn_batch(qs, docs, 5)
        for b in (0, 2):
            one = itt.maxsim_knn(qs[b], docs, 5)
            assert torch.equal(idx[b], one[1]) and torch.isfinite(vals[b]).all()
        assert (vals[1] == np.inf).all()

    def test_zero_padded_ragged_queries_exact(self, rng):
        docs = rng.standard_normal((130, 6, 8)).astype(np.float32)
        q_short = rng.standard_normal((3, 8)).astype(np.float32)
        q_padded = np.zeros((1, 7, 8), np.float32)
        q_padded[0, :3] = q_short
        vals, idx = itt.maxsim_knn_batch(q_padded, docs, 4)
        wv, wi = jax_kernel_path(it.maxsim_knn_batch, q_padded, docs, 4)
        assert_knn_close((vals, idx), (wv, wi), 1e-4)

    def test_small_corpus_takes_the_kernel_function(self):
        """Below 128 documents the JAX package scores with batch_maxsim,
        which without a doc_mask keeps a -inf best; the port clamps it to
        0.0 at every size, as the kernel path does."""
        q = np.ones((1, 2), np.float32)
        docs = np.array([[[-np.inf, 0.0]], [[-1.0, -1.0]]], np.float32)
        vals, idx = itt.maxsim_knn(q, docs, 2)
        assert vals.tolist() == [0.0, -2.0] and idx.tolist() == [0, 1]
        assert np.asarray(it.maxsim_knn(q, docs, 2)[0]).tolist() == [-2.0, -np.inf]

    def test_f32_corpus_is_not_copied(self, rng, monkeypatch):
        docs = torch.from_numpy(rng.standard_normal((130, 4, 8)).astype(np.float32))
        seen = []
        fused = tmk.fused_maxsim_knn
        monkeypatch.setattr(tmk, "fused_maxsim_knn",
                            lambda q, d, k, m=None: seen.append(d) or fused(q, d, k, m))
        tms.maxsim_knn(np.ones((2, 8), np.float32), docs, 3)
        assert seen[0].data_ptr() == docs.data_ptr()

    def test_edges(self, rng):
        docs = rng.standard_normal((10, 4, 8)).astype(np.float32)
        for q, k in ((np.zeros((0, 8), np.float32), 3), (np.ones((2, 8), np.float32), 0)):
            vals, idx = itt.maxsim_knn(q, docs, k)
            assert tuple(vals.shape) == (0,) and idx.dtype == torch.int32
        vals, idx = itt.maxsim_knn(np.ones((2, 8), np.float32), np.zeros((0, 4, 8)), 3)
        assert tuple(idx.shape) == (0,)
        vals, idx = itt.maxsim_knn(np.ones((2, 8), np.float32), docs, 50)  # k > N
        assert tuple(idx.shape) == (10,)
        with pytest.raises(itt.ContractError):
            itt.maxsim_knn(np.ones((2, 9), np.float32), docs, 3)
        with pytest.raises(itt.ContractError):
            itt.maxsim_knn(np.ones((2, 8), np.float32), docs[0], 3)

    def test_batch_edges(self, rng):
        docs = rng.standard_normal((10, 4, 8)).astype(np.float32)
        for qs, k, shape in ((np.ones((3, 0, 8)), 2, (3, 0)), (np.ones((3, 2, 8)), 0, (3, 0)),
                             (np.ones((0, 2, 8)), 2, (0, 0))):
            vals, idx = itt.maxsim_knn_batch(qs, docs, k)
            assert tuple(vals.shape) == shape and tuple(idx.shape) == shape
        with pytest.raises(itt.ContractError):
            itt.maxsim_knn_batch(np.ones((2, 8)), docs, 3)
        with pytest.raises(itt.ContractError):
            itt.maxsim_knn_batch(np.ones((1, 2, 9)), docs, 3)
