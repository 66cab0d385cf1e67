"""The sparse scan's query-tile table (``csrc/sparse_knn.cu``), emulated on
the CPU.

The kernel builds, per tile of queries, a table of the union of their ids:
each id with a mask of the queries that hold it and each one's value at
the first entry of its run in the sorted row; then it looks each corpus
entry up once, and each query whose mask bit is set adds ``fl(v * qv)`` to
its sum in entry order. These tests hold the emulated table to a
per-query lower-bound lookup, the join's contract (duplicates keep the
first occurrence, ids compared as unsigned, the sentinel in no table),
emulate the kernel's sums from the table in float32 (one rounding per
product and per sum, as ``__fmul_rn`` / ``__fadd_rn``), and hold those
scores to the JAX package's
Pallas kernel (``fused_sparse_knn``, interpret mode) and its join
(``_join_scores``): bit for bit on integer values, within cond_tol (32 eps
of the largest sum of |products|) on Gaussian values. The tile choice
(``_table_tile``) is checked against the shared-memory limit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from innr_tpu.kernels import sparse_knn as jsk  # noqa: E402
from innr_tpu.ops.sparse import _join_scores  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import row_scan  # noqa: E402
from innr_tpu_torch.kernels import sparse_knn as tsk  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch.utils.bits import as_unsigned  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


SENTINEL = np.uint32(0xFFFFFFFF)
EPS = float(np.finfo(np.float32).eps)


def queries(rng, n_q, lq, vocab, integer=True):
    """(Q, Lq) uint32 ids sorted as unsigned, drawn from a small vocabulary
    (so the queries share ids), a duplicate in every query, sentinel
    padding of different lengths; float32 values."""
    qi = np.sort(rng.choice(vocab, (n_q, lq)), axis=1).astype(np.uint32)
    qi[:, min(1, lq - 1)] = qi[:, 0]
    for j in range(0, n_q, 3):
        qi[j, lq - j % lq - 1:] = SENTINEL
    qi = np.sort(qi, axis=1)
    qv = (rng.integers(-3, 4, (n_q, lq)) if integer else rng.standard_normal((n_q, lq)))
    return qi, np.where(qi == SENTINEL, 0.0, qv).astype(np.float32)


def vocabulary(rng, size):
    lo = rng.choice(2**31, size // 2, replace=False)
    hi = rng.choice(2**31 - 1, size - size // 2, replace=False) + 2**31
    return np.unique(np.concatenate([lo, hi]).astype(np.uint32))


def corpus(rng, n, l, vocab, integer=True):
    idx = np.full((n, l), SENTINEL, np.uint32)
    val = np.zeros((n, l), np.float32)
    for d in range(1, n):
        nnz = int(rng.integers(1, l + 1))
        idx[d, :nnz] = np.sort(rng.choice(vocab, nnz, replace=False))
        val[d, :nnz] = rng.integers(-4, 5, nnz) if integer else rng.standard_normal(nnz)
    return idx, val


def tables(qi, qv, tile):
    """The kernel's tables of a (Q, Lq) batch cut into tiles of ``tile``
    queries: ``(uid (T, U), uval (T, U, tile), umask (T, U))``, U = max(1,
    tile Lq), ids ascending as unsigned then sentinel padding. An id enters
    from the first entry of its run in a row (csrc/sparse_knn.cu:
    first_of_id), which sets the query's mask bit and value."""
    n_q, lq = qi.shape
    n_t, u = -(-n_q // tile), max(1, tile * lq)
    uid = np.full((n_t, u), SENTINEL, np.uint32)
    uval = np.zeros((n_t, u, tile), np.float32)
    umask = np.zeros((n_t, u), np.uint32)
    for t in range(n_t):
        table = {}
        for j in range(tile):
            q = t * tile + j
            for p in range(lq if q < n_q else 0):
                x = int(qi[q, p])
                if x == SENTINEL or (p > 0 and qi[q, p - 1] == x):
                    continue
                mask, vals = table.setdefault(x, [0, np.zeros(tile, np.float32)])
                table[x][0] = mask | 1 << j
                vals[j] = qv[q, p]
        for i, x in enumerate(sorted(table)):
            uid[t, i], umask[t, i], uval[t, i] = x, table[x][0], table[x][1]
    return uid, uval, umask


def lower_bound_value(qrow, vrow, x):
    """The join's match of id x in one sorted query: its first occurrence."""
    pos = int(np.searchsorted(qrow, x, side="left"))
    return (pos < len(qrow) and qrow[pos] == x), (vrow[pos] if pos < len(qrow) else 0.0)


def emulate(qi, qv, idx, val, tile):
    """The kernel's (Q, N) float32 scores from the tables: each entry
    looked up once, each holding query's product and sum rounded to
    float32, entries in order, sums from +0.0."""
    n_q = qi.shape[0]
    uid, uval, umask = tables(qi, qv, tile)
    out = np.zeros((n_q, idx.shape[0]), np.float32)
    for t in range(uid.shape[0]):
        where = {int(x): u for u, x in enumerate(uid[t]) if x != SENTINEL}
        for d in range(idx.shape[0]):
            acc = np.zeros(tile, np.float32)
            for x, v in zip(idx[d], val[d]):
                u = where.get(int(x))
                if u is None:
                    continue
                for j in range(tile):
                    if umask[t, u] >> j & 1:
                        acc[j] = np.float32(acc[j] + np.float32(v * uval[t, u, j]))
            m = min(tile, n_q - t * tile)
            out[t * tile:t * tile + m, d] = acc[:m]
    return out


class TestUnionTables:
    @pytest.mark.parametrize("n_q,lq,tile", [(1, 1, 1), (5, 8, 4), (13, 6, 16), (16, 24, 8),
                                             (3, 0, 2)])
    def test_equals_per_query_lower_bound(self, rng, n_q, lq, tile):
        vocab = vocabulary(rng, 12)
        qi, qv = queries(rng, n_q, lq, vocab) if lq else (
            np.zeros((n_q, 0), np.uint32), np.zeros((n_q, 0), np.float32))
        uid, uval, umask = tables(qi, qv, tile)
        n_t = -(-n_q // tile)
        assert uid.shape == (n_t, max(1, tile * lq)) and uval.shape == uid.shape + (tile,)
        for t in range(n_t):
            rows = range(t * tile, min(n_q, t * tile + tile))
            want = sorted({int(x) for j in rows for x in qi[j] if x != SENTINEL})
            got = [int(x) for x in uid[t] if x != SENTINEL]
            assert got == want  # distinct, ascending as unsigned, no sentinel
            assert (uid[t, len(got):] == SENTINEL).all()
            assert (umask[t, len(got):] == 0).all()
            for u, x in enumerate(got):
                for j in range(tile):
                    q = t * tile + j
                    hit, value = (lower_bound_value(qi[q], qv[q], x) if q < n_q
                                  else (False, 0.0))
                    assert bool(umask[t, u] >> j & 1) == hit
                    assert uval[t, u, j] == (value if hit else 0.0)

    def test_first_occurrence_of_a_duplicate_counts(self):
        qi = np.array([[5, 5, 9, SENTINEL]], np.uint32)
        qv = np.array([[2.0, 7.0, 3.0, 0.0]], np.float32)
        uid, uval, umask = tables(qi, qv, 1)
        assert uid[0, :2].tolist() == [5, 9] and uval[0, :2, 0].tolist() == [2.0, 3.0]
        assert umask[0, :3].tolist() == [1, 1, 0]

    def test_unsigned_order_and_high_ids(self):
        qi = np.array([[3, 2**31, 2**32 - 2, SENTINEL]], np.uint32)
        uid, _, umask = tables(qi, np.ones((1, 4), np.float32), 1)
        assert uid[0, :3].tolist() == [3, 2**31, 2**32 - 2] and umask[0, 3] == 0


class TestEmulatedKernel:
    @pytest.mark.parametrize("n_q,lq,tile", [(1, 7, 1), (5, 8, 4), (16, 12, 16), (13, 12, 8)])
    def test_integer_scores_equal_jax_kernel_and_join(self, rng, n_q, lq, tile):
        vocab = vocabulary(rng, 20)
        idx, val = corpus(rng, 300, 6, vocab)
        val[5, 0], val[6, 0] = np.nan, np.inf  # count only where matched
        qi, qv = queries(rng, n_q, lq, vocab)
        got = emulate(qi, qv, idx, val, tile)
        for q in range(n_q):
            join = np.asarray(_join_scores(jnp.asarray(qi[q]), jnp.asarray(qv[q]),
                                           jnp.asarray(idx), jnp.asarray(val)))
            np.testing.assert_array_equal(np.isnan(got[q]), np.isnan(join))
            fin = ~np.isnan(join)
            np.testing.assert_array_equal(got[q][fin], join[fin])
            port = tsk.join_scores(as_unsigned(qi[q], 32), torch.from_numpy(qv[q]),
                                   as_unsigned(idx, 32), torch.from_numpy(val)).numpy()
            np.testing.assert_array_equal(np.isnan(got[q]), np.isnan(port))
            np.testing.assert_array_equal(got[q][fin].view(np.int32), port[fin].view(np.int32))
            ks, ki = jsk.fused_sparse_knn(jnp.asarray(qi[q]), jnp.asarray(qv[q]),
                                          jnp.asarray(idx.T), jnp.asarray(val.T), 5)
            ks, ki = np.asarray(ks), np.asarray(ki)
            want = got[q][ki]
            np.testing.assert_array_equal(np.isnan(want), np.isnan(ks))
            np.testing.assert_array_equal(want[~np.isnan(ks)], ks[~np.isnan(ks)])

    def test_gaussian_within_cond_tol_of_jax_kernel(self, rng):
        vocab = vocabulary(rng, 16)
        idx, val = corpus(rng, 400, 8, vocab, integer=False)
        qi, qv = queries(rng, 6, 10, vocab, integer=False)
        got = emulate(qi, qv, idx, val, 8)
        tol = 32 * EPS * np.abs(val).sum(axis=1).max() * np.abs(qv).max()
        for q in range(6):
            ks, ki = (np.asarray(a) for a in jsk.fused_sparse_knn(
                jnp.asarray(qi[q]), jnp.asarray(qv[q]), jnp.asarray(idx.T), jnp.asarray(val.T),
                8))
            np.testing.assert_allclose(got[q][ki], ks, rtol=0, atol=tol)


class TestTableTile:
    @pytest.mark.parametrize("n_q,lq,k", [(1, 1, 1), (16, 64, 10), (16, 64, 256), (16, 300, 10),
                                          (5, 1000, 10), (1, 4096, 10)])
    def test_fits_and_holds_the_union(self, n_q, lq, k):
        tile, hbits = tsk._table_tile(n_q, lq, k)
        assert tile in (1, 2, 4, 8, 16) and tile <= row_scan.query_tile(n_q)
        assert (1 << hbits) >= 2 * max(1, tile * lq) and hbits >= 4
        half, hbits_half = tsk._table_smem(tile, lq, k, 1)
        assert half - 8 * (1 << hbits_half) + 8 * (1 << hbits) <= row_scan.SMEM_LIMIT

    def test_the_b16_cell_keeps_one_tile_and_two_ctas_per_sm(self):
        tile, hbits = tsk._table_tile(16, 64, 10)
        assert tile == 16
        assert tsk._table_smem(16, 64, 10, 1)[0] <= row_scan.SMEM_LIMIT // 2

    def test_a_large_union_splits_the_batch(self):
        assert tsk._table_tile(16, 400, 10)[0] < 16

    def test_a_query_too_large_raises(self):
        with pytest.raises(ContractError, match="shared memory"):
            tsk._table_tile(1, 100_000, 10)
