"""Repairs of the port faults F2-F4 (ROADMAP queue 3), each against an oracle.

- F2: ``IVFIndex`` selects on (key, original index), so ties go to the
  lowest original index as in a full scan, whatever the cluster layout.
  Held bit for bit to the port's ``batch_knn*`` and to the JAX package's
  ``batch_knn*`` on integer-valued corpora (many exact ties). Not to JAX's
  IVF, which breaks ties by layout position (ROADMAP R9).
- F3: a sparse query whose table does not fit in shared memory runs in the
  kernel with the table in global memory, bit for bit the shared-memory
  path and the plain version (``cuda``-marked: the kernel runs only on the
  card).
- F4: sparse MaxSim sorts each query token by index, so unsorted tokens
  score the true sparse dot (a dictionary oracle). JAX is held only on
  sorted queries: on unsorted ones it drops matches (ROADMAP R10).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.kernels import row_scan  # noqa: E402
from innr_tpu_torch.kernels import sparse_knn as tsk  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


FULL = {"dot": tt.batch_knn_dot, "l2": tt.batch_knn, "cosine": tt.batch_knn_cosine}
JAX_FULL = {"dot": it.batch_knn_dot, "l2": it.batch_knn, "cosine": it.batch_knn_cosine}


def roadmap_f2_input():
    """ROADMAP F2: two clusters; rows 0 and 1 both score 5.0 on the query
    and land in different clusters, the odd row first in the layout."""
    rng = np.random.default_rng(0)
    rows = np.zeros((256, 4), np.float32)
    rows[1::2, 0] = 10.0
    rows[0::2, 1] = 10.0
    rows += rng.normal(0.0, 0.1, rows.shape).astype(np.float32)
    rows[0] = (0, 1, 0, 5)
    rows[1] = (1, 0, 0, 5)
    return rows, np.array([[0, 0, 0, 1]], np.float32)


def integer_corpus(seed: int, n: int = 600, d: int = 4):
    """Integer rows in [-2, 2] around four centres: the layout permutes the
    rows, and duplicate rows tie exactly in every metric."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(-6, 7, (4, d))
    rows = centres[rng.integers(0, 4, n)] + rng.integers(-2, 3, (n, d))
    qs = centres[[0, 2, 3]] + rng.integers(-1, 2, (3, d))
    return rows.astype(np.float32), qs.astype(np.float32)


def same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


class TestF2IvfTies:
    @pytest.mark.parametrize("k", [1, 2])
    def test_roadmap_input(self, k):
        rows, q = roadmap_f2_input()
        got = tt.IVFIndex(rows, n_clusters=2, metric="dot").search_batch(q, k)
        assert got.indices.tolist() == [[0, 1][:k]]
        want = tt.batch_knn_dot(q, tt.VerticalBatch(rows), k)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert same_bits(got.scores, want.scores)

    @pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
    @pytest.mark.parametrize("k", [1, 10, 256, 259])
    def test_integer_corpus_equals_the_full_scans(self, metric, k):
        rows, qs = integer_corpus(k)
        index = tt.IVFIndex(rows, n_clusters=4, metric=metric, n_iters=2)
        orig = index.orig_idx.numpy()
        assert not np.array_equal(orig[orig >= 0], np.arange(len(rows)))  # the layout permutes
        got = index.search_batch(qs, k)
        want = FULL[metric](qs, tt.VerticalBatch(rows), k)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert same_bits(got.scores, want.scores)
        ref = JAX_FULL[metric](qs, it.VerticalBatch(rows), k)
        ref_idx, ref_scores = np.asarray(ref.indices), np.asarray(ref.scores)
        if metric != "cosine":
            np.testing.assert_array_equal(got.indices, ref_idx)
            assert same_bits(got.scores, ref_scores)
            return
        # Unit queries are not integers: the two packages' dots of them round
        # in other orders (a few ulps of 1.0), so rows of one direction and
        # other lengths, equal in exact arithmetic, may order differently.
        # Scores within 1e-6; indices equal wherever JAX's ranking separates
        # a rank from both neighbours by more than that.
        np.testing.assert_allclose(got.scores, ref_scores, rtol=0, atol=1e-6)
        gap = np.abs(np.diff(ref_scores, axis=1)) > 2e-6
        edge = np.ones((len(qs), 1), bool)
        separated = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)
        np.testing.assert_array_equal(got.indices[separated], ref_idx[separated])

    def test_k_above_the_pass_cap_carries_the_ids_through_every_pass(self, monkeypatch):
        monkeypatch.setattr(tk, "_K_MAX_PASS", 7)
        rows, qs = integer_corpus(3)
        for metric in FULL:
            got = tt.IVFIndex(rows, n_clusters=4, metric=metric, n_iters=2).search_batch(qs, 23)
            want = FULL[metric](qs, tt.VerticalBatch(rows), 23)
            np.testing.assert_array_equal(got.indices, want.indices)
            assert same_bits(got.scores, want.scores)

    def test_padding_ids_are_distinct_and_never_returned(self):
        rows, qs = integer_corpus(5)
        index = tt.IVFIndex(rows, n_clusters=4, metric="dot", n_iters=2)
        ids = index._ids.numpy()
        assert len(np.unique(ids)) == len(ids)
        assert (ids[index.orig_idx.numpy() < 0] > len(rows)).all()
        got = index.search_batch(qs, len(rows))
        assert (np.sort(got.indices, axis=1) == np.arange(len(rows))).all()

    def test_row_ids_without_a_layout_change_nothing(self, rng):
        rows = torch.from_numpy(rng.integers(-3, 4, (300, 8)).astype(np.float32))
        qs = torch.from_numpy(rng.integers(-3, 4, (4, 8)).astype(np.float32))
        ident = torch.arange(300, dtype=torch.int32)
        for mode, aux in (("dot", None), ("l2", tk._norms2(rows))):
            a = tk.fused_knn_keys_batch(qs, rows, aux, 17, mode)
            b = tk.fused_knn_keys_batch(qs, rows, aux, 17, mode, ident)
            assert all(torch.equal(x, y) for x, y in zip(a, b))

    def test_reversed_ids_reverse_the_tie_order(self):
        rows = torch.ones((5, 3))
        qs = torch.ones((1, 3))
        ids = torch.tensor([40, 30, 20, 10, 0], dtype=torch.int32)
        _, idx = tk.fused_knn_keys_batch(qs, rows, None, 5, "dot", ids)
        assert idx.tolist() == [[0, 10, 20, 30, 40]]
        with pytest.raises(tt.ContractError, match="row_ids"):
            tk.fused_knn_keys_batch(qs, rows, None, 5, "dot", ids[:4])


def dict_sparse_maxsim(query, doc):
    """sum over query tokens of the max over document tokens of the true
    sparse dot (dictionaries: unique ids, any order); 0.0 if empty."""
    if not query or not doc:
        return 0.0
    total = 0.0
    for qi, qv in query:
        qd = dict(zip(qi, qv))
        total += max(sum(qd.get(i, 0.0) * v for i, v in zip(di, dv)) for di, dv in doc)
    return total


class TestF4UnsortedSparseMaxSimQueries:
    QUERY = [([48, 28, 33, 35, 24], [-1.391, -1.559, 1.129, -0.489, -0.163])]

    def test_roadmap_input(self):
        doc = [([35], [-1.756])]
        want = np.float32(-0.489) * np.float32(-1.756)
        assert abs(float(tt.sparse_maxsim(self.QUERY, doc)) - want) < 1e-6
        assert abs(float(tt.sparse_maxsim_batch(self.QUERY, [doc])[0]) - 0.858684) < 1e-6
        vals, idx = tt.sparse_maxsim_knn(self.QUERY, [[([4], [1.0])], doc], 1)
        assert idx.tolist() == [1] and abs(float(vals[0]) - 0.858684) < 1e-6

    def test_roadmap_three_token_document(self):
        doc = [([4, 5, 21], [1.0, 1.0, 1.0]), ([10, 42], [1.0, 1.0]),
               ([18, 19, 23, 26, 28, 35], [-0.619, -1.277, -0.547, 1.424, -0.828, -1.756])]
        got = float(tt.sparse_maxsim_batch(self.QUERY, [doc])[0])
        assert abs(got - dict_sparse_maxsim(self.QUERY, doc)) < 1e-5
        assert abs(got - 2.149) < 1e-3

    @pytest.mark.parametrize("trial", range(20))
    def test_random_unsorted_against_the_oracle(self, trial):
        rng = np.random.default_rng(1000 + trial)

        def token():
            m = int(rng.integers(1, 6))
            ids = rng.choice(50, m, replace=False)
            return ids.tolist(), rng.standard_normal(m).astype(np.float32).tolist()

        query = [token() for _ in range(int(rng.integers(1, 4)))]
        docs = [[token() for _ in range(int(rng.integers(1, 4)))] for _ in range(20)]
        want = np.array([dict_sparse_maxsim(query, d) for d in docs])
        got = tt.sparse_maxsim_batch(query, docs).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert abs(float(tt.sparse_maxsim(query, docs[0])) - want[0]) < 1e-5
        # The pre-padded 2-D form is sorted too, its padding kept last.
        padded = tt.pad_sparse(query, width=7)
        np.testing.assert_allclose(tt.sparse_maxsim_batch(padded, docs).numpy(), want,
                                   rtol=0, atol=1e-5)
        _, idx = tt.sparse_maxsim_knn(query, docs, 5)
        assert idx.tolist() == torch.topk(torch.from_numpy(got), 5).indices.tolist() or \
            np.allclose(np.sort(got)[::-1][:5], got[idx.numpy()])

    @pytest.mark.parametrize("trial", range(5))
    def test_sorted_queries_against_jax(self, trial):
        rng = np.random.default_rng(2000 + trial)

        def token():
            m = int(rng.integers(1, 6))
            ids = np.sort(rng.choice(50, m, replace=False)).astype(np.uint32)
            return ids, rng.standard_normal(m).astype(np.float32)

        query = [token() for _ in range(3)]
        docs = [[token() for _ in range(int(rng.integers(1, 4)))] for _ in range(20)]
        got = tt.sparse_maxsim_batch(query, docs).numpy()
        want = np.asarray(it.sparse_maxsim_batch(query, docs))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


def _sparse_case(dev, n_q, lq, n=3000, l=8, vocab=40_000, seed=5):
    """Integer values (exact sums in any order), ids over a vocabulary larger
    than the query, each query and document sorted as unsigned."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flip = torch.iinfo(torch.int32).min
    ids = torch.randint(0, vocab, (l, n), generator=gen, device=dev, dtype=torch.int32)
    ids = torch.sort(ids ^ flip, dim=0).values ^ flip
    vals = torch.randint(-4, 5, (l, n), generator=gen, device=dev).float()
    qi = torch.stack([torch.randperm(vocab, generator=gen, device=dev)[:lq]
                      for _ in range(n_q)]).to(torch.int32)
    qi = torch.sort(qi ^ flip, dim=1).values ^ flip
    qv = torch.randint(-3, 4, (n_q, lq), generator=gen, device=dev).float()
    return qi, qv, ids, vals


@pytest.mark.cuda
class TestF3LongSparseQueriesOnCuda:
    @pytest.mark.parametrize("n_q", [1, 16])
    @pytest.mark.parametrize("lq", [8193, 20_000])
    def test_long_queries_run_in_the_kernel(self, cuda_device, n_q, lq):
        qi, qv, ids, vals = _sparse_case(cuda_device, n_q, lq)
        before = tsk.LAUNCHES
        got = tsk.fused_sparse_keys_batch(qi, qv, ids, vals, 10)
        assert tsk.LAUNCHES == before + 1
        want = tsk.sparse_knn_plain(qi, qv, ids, vals, 10)
        assert all(torch.equal(x, y) for x, y in zip(got, want))

    @pytest.mark.parametrize("n_q,k", [(1, 10), (5, 259), (16, 10)])
    def test_global_table_equals_the_shared_one(self, cuda_device, monkeypatch, n_q, k):
        qi, qv, ids, vals = _sparse_case(cuda_device, n_q, 2000)
        shared = tsk.fused_sparse_keys_batch(qi, qv, ids, vals, k)
        # Room for one query's top-k buffers at k = 256 (17,536 bytes), not
        # for its table of 2000 ids (48 KB).
        monkeypatch.setattr(row_scan, "SMEM_LIMIT", 24_000)
        assert tsk._table_plan(n_q, 2000, min(k, 256))[2] > 0  # the global path
        moved = tsk.fused_sparse_keys_batch(qi, qv, ids, vals, k)
        want = tsk.sparse_knn_plain(qi, qv, ids, vals, k)
        assert all(torch.equal(x, y) for x, y in zip(moved, shared))
        assert all(torch.equal(x, y) for x, y in zip(moved, want))

    @pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
    @pytest.mark.parametrize("k", [1, 10, 256, 259])
    def test_f2_ivf_ties_on_the_card(self, cuda_device, metric, k):
        rows, qs = integer_corpus(k, n=4000, d=16)
        index = tt.IVFIndex(rows, n_clusters=8, metric=metric, n_iters=2, device=cuda_device)
        got = index.search_batch(qs, k)
        want = FULL[metric](qs, tt.VerticalBatch(rows, device=cuda_device), k)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert same_bits(got.scores, want.scores)


class TestF3TablePlan:
    def test_a_table_too_large_for_shared_memory_goes_to_global_memory(self):
        for n_q, lq, k in ((1, 8193, 256), (1, 20_000, 10), (16, 20_000, 10),
                           (1, 100_000, 10)):
            tile, hbits, in_global = tsk._table_plan(n_q, lq, k)
            assert in_global > 0 and tile <= row_scan.query_tile(n_q)
            assert (1 << hbits) >= 4 * tile * lq
            assert in_global <= tsk._GLOBAL_TABLE_BYTES or tile == 1

    def test_a_table_that_fits_stays_in_shared_memory(self):
        for n_q, lq, k in ((16, 64, 10), (1, 4096, 10), (5, 1000, 10)):
            assert tsk._table_plan(n_q, lq, k) == (*tsk._table_tile(n_q, lq, k), 0)
