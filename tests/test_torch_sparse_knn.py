"""innr_tpu_torch.kernels.sparse_knn against innr_tpu's Pallas sparse kernel.

The same numpy corpus goes through the JAX kernel (interpret mode on the
CPU, both ``fast`` values where the corpus allows) and the port, which runs
the plain version of its CUDA kernel on CPU tensors. Indices span the full
32 bits (hashed index spaces: >= 2**31 is negative in the port's int32
view, so a signed order would break the search), padding is the sentinel.
Integer-valued data: every product and sum is exact, so scores and indices
are equal; Gaussian data: scores within cond_tol, indices equal where the
ranking separates them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from innr_tpu.kernels import sparse_knn as jsk  # noqa: E402
from innr_tpu.ops.sparse import _corpus_scores  # noqa: E402
from innr_tpu.utils.order import top_k_total  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
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


def vocabulary(rng, size=64):
    """Sorted unique uint32 ids, half of them >= 2**31."""
    lo = rng.choice(2**31, size // 2, replace=False)
    hi = rng.choice(2**31 - 1, size // 2, replace=False) + 2**31
    return np.unique(np.concatenate([lo, hi]).astype(np.uint32))


def corpus(rng, n, l, vocab, integer=True):
    """(N, L) uint32 ids sorted as unsigned, sentinel-padded, and values;
    document 0 is empty (all sentinel), doc 1 has one entry."""
    idx = np.full((n, l), SENTINEL, np.uint32)
    val = np.zeros((n, l), np.float32)
    for d in range(1, n):
        nnz = 1 if d == 1 else int(rng.integers(1, l + 1))
        idx[d, :nnz] = np.sort(rng.choice(vocab, nnz, replace=False))
        val[d, :nnz] = (rng.integers(-4, 5, nnz) if integer else rng.standard_normal(nnz))
    return idx, val


def query(rng, lq, vocab, integer=True):
    qi = np.sort(rng.choice(vocab, lq, replace=False)).astype(np.uint32)
    qv = (rng.integers(-3, 4, lq) if integer else rng.standard_normal(lq)).astype(np.float32)
    return qi, qv


def port(*arrays):
    return tuple(as_unsigned(a, 32) if a.dtype == np.uint32 else torch.from_numpy(a)
                 for a in arrays)


def jax_kernel(qi, qv, idx, val, k, fast=False):
    return jsk.fused_sparse_knn(jnp.asarray(qi), jnp.asarray(qv), jnp.asarray(idx.T),
                                jnp.asarray(val.T), k, fast=fast)


def jax_join(qi, qv, idx, val, k):
    """The JAX package's XLA join and total-order top-k: the oracle."""
    scores = _corpus_scores(jnp.asarray(qi), jnp.asarray(qv), jnp.asarray(idx), jnp.asarray(val))
    return top_k_total(scores, k, largest=True)


def run_port(qi, qv, idx, val, k):
    q_idx, q_val, c_idx, c_val = port(qi, qv, np.ascontiguousarray(idx.T),
                                      np.ascontiguousarray(val.T))
    return tsk.fused_sparse_knn(q_idx, q_val, c_idx, c_val, k)


def assert_bits_equal(got, want):
    """Scores bit for bit (any NaN as one NaN) and indices equal."""
    (gs, gi), (ws, wi) = got, want
    gs, ws = gs.numpy(), np.asarray(ws)
    np.testing.assert_array_equal(np.isnan(gs), np.isnan(ws))
    fin = ~np.isnan(ws)
    np.testing.assert_array_equal(gs[fin].view(np.int32), ws[fin].view(np.int32))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


class TestScanAgainstJax:
    @pytest.mark.parametrize("fast", [False, True])
    @pytest.mark.parametrize("n,l,lq", [(700, 8, 24), (1100, 1, 1), (513, 5, 7)])
    def test_integer_valued_exact(self, rng, fast, n, l, lq):
        vocab = vocabulary(rng)
        idx, val = corpus(rng, n, l, vocab)
        qi, qv = query(rng, lq, vocab)
        got = run_port(qi, qv, idx, val, 9)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        assert_bits_equal(got, jax_kernel(qi, qv, idx, val, 9, fast))
        assert_bits_equal(got, jax_join(qi, qv, idx, val, 9))

    def test_gaussian_within_cond_tol(self, rng):
        vocab = vocabulary(rng, 24)
        idx, val = corpus(rng, 900, 8, vocab, integer=False)
        qi, qv = query(rng, 12, vocab, integer=False)
        k = 10
        gs, gi = run_port(qi, qv, idx, val, k)
        js, ji = (np.asarray(a) for a in jax_kernel(qi, qv, idx, val, k + 1))
        # cond_tol per document: 32 eps sum |val * qv| over its matches.
        cond = np.abs(val).sum(axis=1).max() * np.abs(qv).max()
        tol = 32 * EPS * cond
        np.testing.assert_allclose(gs.numpy(), js[:k], rtol=0, atol=tol)
        gaps = np.minimum(np.abs(np.diff(js))[:k], np.r_[np.inf, np.abs(np.diff(js))[:k - 1]])
        sep = gaps > 2 * tol
        np.testing.assert_array_equal(gi.numpy()[sep], ji[:k][sep])

    def test_sentinel_nan_inf_zero_and_empty_docs(self, rng):
        """A NaN or inf counts only where its entry matches; no match, a
        -0.0 product or only unmatched NaNs score +0.0. Query values are
        nonzero: inf * 0 makes the CPU's default NaN, whose sign the JAX
        package keeps and the port canonicalises (ROADMAP ground rules)."""
        vocab = vocabulary(rng, 32)
        idx, val = corpus(rng, 640, 6, vocab)
        qi, qv = query(rng, 10, vocab)
        qv[qv == 0] = 1.0
        hit, miss, miss2 = qi[3], *np.setdiff1d(vocab, qi)[:2]

        def doc(d, entries):
            ids = np.array(sorted(entries), np.uint32)
            idx[d], val[d] = SENTINEL, 0.0
            idx[d, :len(ids)] = ids
            val[d, :len(ids)] = [entries[i] for i in ids]

        doc(5, {hit: np.nan, miss: 2.0})      # matched NaN: NaN, ranked first
        doc(6, {miss: np.nan, miss2: np.nan})  # unmatched NaNs: +0.0
        doc(7, {hit: np.inf})                  # matched inf: +-inf
        doc(8, {miss: -np.inf})                # unmatched -inf: +0.0
        doc(9, {hit: -0.0})                    # a -0.0 product: +0.0
        k = 60
        got = run_port(qi, qv, idx, val, k)
        assert_bits_equal(got, jax_kernel(qi, qv, idx, val, k, fast=False))
        assert_bits_equal(got, jax_join(qi, qv, idx, val, k))
        assert np.isnan(got[0][0]) and got[1][0] == 5
        full = dict(zip(*(t.tolist() for t in reversed(run_port(qi, qv, idx, val, 640)))))
        assert full[7] == (np.inf if qv[3] > 0 else -np.inf)
        for d in (0, 6, 8, 9):  # empty, unmatched NaN, unmatched -inf, -0.0 product
            assert np.float32(full[d]).view(np.int32) == 0  # +0.0

    def test_duplicate_query_indices_first_occurrence_wins(self, rng):
        vocab = vocabulary(rng, 16)
        idx, val = corpus(rng, 520, 4, vocab)
        qi = np.sort(np.array([vocab[1], vocab[5], vocab[5], vocab[12]], np.uint32))
        qv = np.array([1.0, 5.0, -5.0, 2.0], np.float32)
        got = run_port(qi, qv, idx, val, 6)
        assert_bits_equal(got, jax_kernel(qi, qv, idx, val, 6))
        assert_bits_equal(got, jax_join(qi, qv, idx, val, 6))

    def test_unsigned_order_of_the_search(self):
        """A query sorted as unsigned has its ids >= 2**31 last; each is
        found (a signed search of the int32 views would miss them)."""
        ids = np.array([3, 2**31 - 1, 2**31, 2**32 - 2], np.uint32)
        idx = np.stack([ids, np.roll(ids, 1)])
        idx = np.sort(idx, axis=1)
        val = np.ones_like(idx, dtype=np.float32)
        qv = np.array([1.0, 10.0, 100.0, 1000.0], np.float32)
        scores, order = run_port(ids, qv, idx, val, 2)
        assert scores.tolist() == [1111.0, 1111.0] and order.tolist() == [0, 1]
        scores, _ = run_port(ids[2:], qv[2:], idx[:1], val[:1], 1)
        assert scores.tolist() == [1100.0]

    def test_empty_query_scores_zero(self, rng):
        idx, val = corpus(rng, 300, 4, vocabulary(rng))
        e = np.zeros(0, np.uint32)
        scores, order = run_port(e, np.zeros(0, np.float32), idx, val, 5)
        assert order.tolist() == [0, 1, 2, 3, 4]
        assert (scores.numpy().view(np.int32) == 0).all()

    def test_batch_equals_per_query(self, rng):
        vocab = vocabulary(rng)
        idx, val = corpus(rng, 800, 6, vocab)
        lens = [1, 9, 4]
        q_idx = np.full((3, 9), SENTINEL, np.uint32)
        q_val = np.zeros((3, 9), np.float32)
        for j, lq in enumerate(lens):
            q_idx[j, :lq], q_val[j, :lq] = query(rng, lq, vocab)
        args = port(q_idx, q_val, np.ascontiguousarray(idx.T), np.ascontiguousarray(val.T))
        scores, order = tsk.fused_sparse_knn_batch(*args, 7)
        for j in range(3):
            one = tsk.fused_sparse_knn(args[0][j], args[1][j], *args[2:], 7)
            assert torch.equal(order[j], one[1]) and torch.equal(scores[j], one[0])
            assert_bits_equal(one, jax_join(q_idx[j], q_val[j], idx, val, 7))

    def test_multi_pass_with_cap_patched_down(self, rng, monkeypatch):
        """k beyond the pass cap: exclusion-bounded passes equal one
        selection (the JAX package's XLA join and top_k_total), ties
        included."""
        monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
        pass_ks, plain_top = [], tsk._plain_top
        monkeypatch.setattr(tsk, "_plain_top", lambda *a: pass_ks.append(a[4]) or plain_top(*a))
        vocab = vocabulary(rng, 8)
        idx, val = corpus(rng, 600, 3, vocab)
        qi, qv = query(rng, 4, vocab)
        assert_bits_equal(run_port(qi, qv, idx, val, 45), jax_join(qi, qv, idx, val, 45))
        assert pass_ks == [16, 16, 13]

    def test_plain_exclusion_bound_and_chunks(self, rng, monkeypatch):
        vocab = vocabulary(rng, 16)
        idx, val = corpus(rng, 700, 4, vocab)
        q = [query(rng, 5, vocab) for _ in range(2)]
        args = port(np.stack([a for a, _ in q]), np.stack([b for _, b in q]),
                    np.ascontiguousarray(idx.T), np.ascontiguousarray(val.T))
        first_k, first_i = tsk.sparse_knn_plain(*args, 5)
        keys, order = tsk.sparse_knn_plain(*args, 7, excl=(first_k[:, -1], first_i[:, -1]))
        full_k, full_i = tsk.sparse_knn_plain(*args, 12)
        assert torch.equal(full_i[:, 5:], order) and torch.equal(full_k[:, 5:], keys)
        monkeypatch.setattr(tsk, "_PLAIN_CHUNK", 1)  # 256-document chunks
        chunked = tsk.sparse_knn_plain(*args, 12)
        assert torch.equal(chunked[0], full_k) and torch.equal(chunked[1], full_i)


class TestJoinScores:
    def test_any_shape_and_dim(self, rng):
        vocab = vocabulary(rng, 16)
        idx, val = corpus(rng, 30, 5, vocab)
        qi, qv = query(rng, 6, vocab)
        want = np.asarray(_corpus_scores(jnp.asarray(qi), jnp.asarray(qv), jnp.asarray(idx),
                                         jnp.asarray(val)))
        t = port(qi, qv, idx, val)
        np.testing.assert_array_equal(tsk.join_scores(*t).numpy(), want)
        np.testing.assert_array_equal(
            tsk.join_scores(t[0], t[1], t[2].T, t[3].T, dim=0).numpy(), want)
        empty = tsk.join_scores(t[0][:0], t[1][:0], t[2], t[3])
        assert empty.shape == (30,) and (empty == 0).all()


class TestDispatchAndContracts:
    def _args(self, rng, n=400):
        vocab = vocabulary(rng, 16)
        idx, val = corpus(rng, n, 4, vocab)
        qi, qv = query(rng, 5, vocab)
        return port(qi[None], qv[None], np.ascontiguousarray(idx.T), np.ascontiguousarray(val.T))

    def test_force_reference_runs_plain(self, rng, monkeypatch):
        args = self._args(rng)
        want = tsk.sparse_knn_plain(*args, 5)
        monkeypatch.setattr(config, "_FORCE_REFERENCE", True)
        before = tsk.LAUNCHES
        got = tsk.fused_sparse_keys_batch(*args, 5)
        assert all(torch.equal(a, b) for a, b in zip(got, want)) and tsk.LAUNCHES == before

    @pytest.mark.parametrize("bad", [
        dict(k=0),
        dict(k=401),
        dict(qi=torch.ones(1, 5, dtype=torch.int64)),
        dict(qv=torch.ones(1, 4)),
        dict(ci=torch.ones(4, 400, dtype=torch.int16)),
        dict(cv=torch.ones(4, 399)),
        dict(qi=torch.ones(5, dtype=torch.int32), qv=torch.ones(5)),
    ])
    def test_scan_raises(self, rng, bad):
        qi, qv, ci, cv = self._args(rng)
        args = dict(qi=qi, qv=qv, ci=ci, cv=cv, k=3)
        args.update(bad)
        with pytest.raises(ContractError):
            tsk.fused_sparse_keys_batch(args["qi"], args["qv"], args["ci"], args["cv"], args["k"])

    def test_meta_device_raises_not_falls_back(self):
        i32, f32 = dict(dtype=torch.int32, device="meta"), dict(device="meta")
        with pytest.raises(ContractError, match="unsupported device"):
            tsk.fused_sparse_keys_batch(torch.ones(1, 2, **i32), torch.ones(1, 2, **f32),
                                        torch.ones(3, 10, **i32), torch.ones(3, 10, **f32), 2)

    def test_fast_flag_selects_nothing(self, rng):
        qi, qv, ci, cv = self._args(rng)
        a = tsk.fused_sparse_knn(qi[0], qv[0], ci, cv, 6, fast=True)
        b = tsk.fused_sparse_knn(qi[0], qv[0], ci, cv, 6, fast=False)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestKernelOnCuda:
    @pytest.mark.parametrize("n_q,lq,l,k", [(1, 1, 1, 1), (1, 64, 32, 10), (16, 300, 7, 259)])
    def test_scan_matches_plain_exactly(self, cuda_device, n_q, lq, l, k):
        gen = torch.Generator(device=cuda_device).manual_seed(11)
        vocab = torch.randint(-(2**31), 2**31, (512,), generator=gen, device=cuda_device,
                              dtype=torch.int32)
        ids = vocab[torch.randint(0, 512, (l, 3077), generator=gen, device=cuda_device)]
        ids = torch.sort(ids ^ torch.iinfo(torch.int32).min, dim=0).values ^ torch.iinfo(
            torch.int32).min  # each document sorted as unsigned
        vals = torch.randint(-4, 5, (l, 3077), generator=gen, device=cuda_device).float()
        qi = vocab[torch.randint(0, 512, (n_q, lq), generator=gen, device=cuda_device)]
        qi = torch.sort(qi ^ torch.iinfo(torch.int32).min, dim=1).values ^ torch.iinfo(
            torch.int32).min
        qv = torch.randint(-3, 4, (n_q, lq), generator=gen, device=cuda_device).float()
        before = tsk.LAUNCHES
        got = tsk.fused_sparse_keys_batch(qi, qv, ids, vals, k)
        assert tsk.LAUNCHES > before
        want = tsk.sparse_knn_plain(qi, qv, ids, vals, k)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
