"""innr_tpu_torch.kernels.packed_knn / .hamming against innr_tpu's Pallas
kernels.

The same numpy words go through the JAX kernels (interpret mode on the
CPU, as innr_tpu's own tests run them) and the port, which runs the plain
versions of its CUDA kernels on CPU tensors. Words are drawn over all 32
bits (the sign bit of the port's int32 view included), ternary planes are
disjoint, and some rows are planted copies of a query, so ties must go to
the lowest row. Every result is an integer: equal counts, dots and indices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from innr_tpu.kernels import hamming as jh  # noqa: E402
from innr_tpu.kernels import packed_knn as jpk  # noqa: E402
from innr_tpu_torch.kernels import hamming as th  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.kernels import packed_knn as tpk  # noqa: E402
from innr_tpu_torch.kernels import row_scan  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch.utils.bits import words_from_numpy as T  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


N = 2100  # >= innr_tpu.config.MIN_ROWS_PALLAS, not a multiple of any tile
# (W, Q): W = 8 is one full sublane chunk of the TPU kernels, 9 a ragged one.
SHAPES = [(1, 1), (3, 5), (8, 16), (9, 1), (9, 16)]


def words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def binary_data(rng, w, n_q, n=N):
    """(queries (Q, W), corpus rows (N, W)); rows 50 and 900 copy row 7,
    and query 0 is row 7."""
    rows = words(rng, (n, w))
    rows[[50, 900]] = rows[7]
    qs = words(rng, (n_q, w))
    qs[0] = rows[7]
    return qs, rows


def ternary_data(rng, w, n_q, n=N):
    """((qpos, qneg), (pos, neg)) with disjoint planes and the same planted
    copies as :func:`binary_data`."""
    a, b = binary_data(rng, w, n_q, n)
    a2, b2 = binary_data(rng, w, n_q, n)
    return (a & a2, a & ~a2), (b & b2, b & ~b2)


class TestScanAgainstJax:
    @pytest.mark.parametrize("w,n_q", SHAPES)
    def test_binary_batch(self, rng, w, n_q):
        qs, rows = binary_data(rng, w, n_q)
        rows_t = np.ascontiguousarray(rows.T)
        jc, ji = jpk.fused_binary_knn_batch(jnp.asarray(qs), jnp.asarray(rows_t), 7)
        tc, ti = tpk.fused_binary_knn_batch(T(qs), T(rows_t), 7)
        assert tc.dtype == torch.int32 and ti.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti[0, :3].tolist() == [7, 50, 900] and (tc[0, :3] == 0).all()

    @pytest.mark.parametrize("w,n_q", SHAPES)
    def test_ternary_batch(self, rng, w, n_q):
        (qp, qn), (pos, neg) = ternary_data(rng, w, n_q)
        pt, nt = np.ascontiguousarray(pos.T), np.ascontiguousarray(neg.T)
        jd, ji = jpk.fused_ternary_knn_batch(
            jnp.asarray(qp), jnp.asarray(qn), jnp.asarray(pt), jnp.asarray(nt), 7)
        td, ti = tpk.fused_ternary_knn_batch(T(qp), T(qn), T(pt), T(nt), 7)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    def test_single_query_forms(self, rng):
        qs, rows = binary_data(rng, 3, 1)
        rows_t = np.ascontiguousarray(rows.T)
        jc, ji = jpk.fused_binary_knn(jnp.asarray(qs[0]), jnp.asarray(rows_t), 5)
        tc, ti = tpk.fused_binary_knn(T(qs[0]), T(rows_t), 5)
        assert tc.shape == (5,)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        (qp, qn), (pos, neg) = ternary_data(rng, 3, 1)
        pt, nt = np.ascontiguousarray(pos.T), np.ascontiguousarray(neg.T)
        jd, ji = jpk.fused_ternary_knn(jnp.asarray(qp[0]), jnp.asarray(qn[0]),
                                       jnp.asarray(pt), jnp.asarray(nt), 5)
        td, ti = tpk.fused_ternary_knn(T(qp[0]), T(qn[0]), T(pt), T(nt), 5)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    @pytest.mark.parametrize("kind", ["binary", "ternary"])
    def test_multi_pass_with_cap_patched_down(self, rng, monkeypatch, kind):
        """k beyond the pass cap: exclusion-bounded passes whose
        concatenation equals jax.lax.top_k's single selection (the JAX
        package's path for k above its cap), ties included."""
        monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
        pass_ks, plain_top = [], tpk._plain_top
        monkeypatch.setattr(
            tpk, "_plain_top", lambda *a: pass_ks.append(a[2]) or plain_top(*a))
        import jax

        if kind == "binary":
            qs, rows = binary_data(rng, 2, 3)
            rows[100:400] = rows[7]  # many ties across pass boundaries
            counts = np.asarray(jnp.sum(jax.lax.population_count(
                jnp.asarray(rows)[None] ^ jnp.asarray(qs)[:, None]).astype(jnp.int32), axis=2))
            _, ji = jax.lax.top_k(-jnp.asarray(counts), 45)
            tc, ti = tpk.fused_binary_knn_batch(T(qs), T(np.ascontiguousarray(rows.T)), 45)
            want = np.take_along_axis(counts, np.asarray(ji), axis=1)
            np.testing.assert_array_equal(tc.numpy(), want)
        else:
            (qp, qn), (pos, neg) = ternary_data(rng, 2, 3)
            dots = np.stack([np.asarray(jh.batch_ternary_dot_words(
                jnp.asarray(qp[i]), jnp.asarray(qn[i]), jnp.asarray(pos), jnp.asarray(neg)))
                for i in range(3)])
            _, ji = jax.lax.top_k(jnp.asarray(dots), 45)
            td, ti = tpk.fused_ternary_knn_batch(
                T(qp), T(qn), T(np.ascontiguousarray(pos.T)), T(np.ascontiguousarray(neg.T)), 45)
            np.testing.assert_array_equal(
                td.numpy(), np.take_along_axis(dots, np.asarray(ji), axis=1))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert pass_ks == [16, 16, 13]

    def test_plain_exclusion_bound(self, rng):
        """packed_knn_plain's excl resumes strictly after (key, idx)."""
        qs, rows = binary_data(rng, 3, 2)
        q, r = (T(qs),), (T(np.ascontiguousarray(rows.T)),)
        first_k, first_i = tpk.packed_knn_plain(q, r, 5)
        keys, idx = tpk.packed_knn_plain(q, r, 7, excl=(first_k[:, -1], first_i[:, -1]))
        full_k, full_i = tpk.packed_knn_plain(q, r, 12)
        assert torch.equal(full_i[:, 5:], idx) and torch.equal(full_k[:, 5:], keys)

    def test_plain_chunks_equal_one_selection(self, rng, monkeypatch):
        """The plain version's running top-k over row chunks selects what
        one selection over all rows does."""
        qs, rows = binary_data(rng, 3, 4)
        q, r = (T(qs),), (T(np.ascontiguousarray(rows.T)),)
        whole = tpk.packed_knn_plain(q, r, 30)
        monkeypatch.setattr(tpk, "_PLAIN_CHUNK", 1)  # 256-row chunks
        chunked = tpk.packed_knn_plain(q, r, 30)
        assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


class TestRowsAgainstJax:
    @pytest.mark.parametrize("w", [1, 3, 8, 9])
    def test_hamming_words(self, rng, w):
        qs, rows = binary_data(rng, w, 1)
        want = np.asarray(jh.batch_hamming_words(jnp.asarray(qs[0]), jnp.asarray(rows)))
        got = th.batch_hamming_words(T(qs[0]), T(rows))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[7] == 0 and got[50] == 0

    @pytest.mark.parametrize("w", [1, 3, 8, 9])
    def test_ternary_dot_words(self, rng, w):
        (qp, qn), (pos, neg) = ternary_data(rng, w, 1)
        want = np.asarray(jh.batch_ternary_dot_words(
            jnp.asarray(qp[0]), jnp.asarray(qn[0]), jnp.asarray(pos), jnp.asarray(neg)))
        got = th.batch_ternary_dot_words(T(qp[0]), T(qn[0]), T(pos), T(neg))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_plain_chunks(self, rng, monkeypatch):
        qs, rows = binary_data(rng, 3, 1)
        whole = th.hamming_rows_plain((T(qs[0]),), (T(rows),))
        monkeypatch.setattr(th, "_PLAIN_CHUNK", 64)
        assert torch.equal(th.hamming_rows_plain((T(qs[0]),), (T(rows),)), whole)


class TestDispatchAndContracts:
    def test_force_reference_runs_plain(self, rng, monkeypatch):
        from innr_tpu_torch import config

        qs, rows = binary_data(rng, 2, 2, n=1000)
        q, r = (T(qs),), (T(np.ascontiguousarray(rows.T)),)
        want = tpk.packed_knn_plain(q, r, 5)
        monkeypatch.setattr(config, "_FORCE_REFERENCE", True)
        before = tpk.LAUNCHES
        got = tpk.fused_packed_keys_batch(q, r, 5)
        assert all(torch.equal(a, b) for a, b in zip(got, want)) and tpk.LAUNCHES == before

    @pytest.mark.parametrize("bad", [
        dict(k=0),
        dict(k=11),
        dict(qs=(torch.ones(2, 3, dtype=torch.int32),)),
        dict(qs=(torch.ones(2, 2, dtype=torch.int64),)),
        dict(planes=(torch.ones(2, 10, dtype=torch.int32),) * 2),
        dict(planes=(torch.ones(10, dtype=torch.int32),)),
    ])
    def test_scan_raises(self, bad):
        args = dict(qs=(torch.ones(2, 2, dtype=torch.int32),),
                    planes=(torch.ones(2, 10, dtype=torch.int32),), k=3)
        args.update(bad)
        with pytest.raises(ContractError):
            tpk.fused_packed_keys_batch(args["qs"], args["planes"], args["k"])

    def test_rows_raise_on_mismatch(self):
        with pytest.raises(ContractError, match="word-count mismatch"):
            th.batch_hamming_words(torch.ones(3, dtype=torch.int32),
                                   torch.ones(10, 2, dtype=torch.int32))

    def test_meta_device_raises_not_falls_back(self):
        meta = dict(dtype=torch.int32, device="meta")
        with pytest.raises(ContractError, match="unsupported device"):
            tpk.fused_packed_keys_batch((torch.ones(1, 2, **meta),), (torch.ones(2, 10, **meta),), 2)
        with pytest.raises(ContractError, match="unsupported device"):
            th.batch_hamming_words(torch.ones(2, **meta), torch.ones(10, 2, **meta))

    @pytest.mark.parametrize("n_q,tile", [(1, 1), (2, 2), (3, 4), (5, 8), (16, 16), (33, 16)])
    def test_query_tile(self, n_q, tile):
        assert row_scan.query_tile(n_q) == tile


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


def _device_words(gen, shape, dev):
    return torch.randint(-(2**31), 2**31, shape, generator=gen, device=dev, dtype=torch.int32)


@pytest.mark.cuda
class TestKernelsOnCuda:
    @pytest.mark.parametrize("kind", ["binary", "ternary"])
    @pytest.mark.parametrize("n_q,k", [(1, 1), (5, 10), (33, 259)])
    def test_scan_matches_plain_exactly(self, cuda_device, kind, n_q, k):
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        a = _device_words(gen, (3, 3077), cuda_device)
        planes = (a,) if kind == "binary" else (a & a.roll(1, 1), a & ~a.roll(1, 1))
        q = _device_words(gen, (n_q, 3), cuda_device)
        qs = (q,) if kind == "binary" else (q & q.roll(1, 0), q & ~q.roll(1, 0))
        before = tpk.LAUNCHES
        got = tpk.fused_packed_keys_batch(qs, planes, k)
        assert tpk.LAUNCHES > before
        want = tpk.packed_knn_plain(qs, planes, k)
        assert all(torch.equal(x, y) for x, y in zip(got, want))

    @pytest.mark.parametrize("kind", ["binary", "ternary"])
    @pytest.mark.parametrize("w", [9, 64])
    @pytest.mark.parametrize("n_q,k", [(32, 10), (64, 256)])
    def test_scan_wide_tiles_and_overlapping_planes(self, cuda_device, kind, w, n_q, k):
        """Query tiles of 32 and 64, ragged and multi-chunk words, ternary
        planes that share positions, rows 3077 (the 4-word loads' tail)."""
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        n_planes = 1 if kind == "binary" else 2
        planes = tuple(_device_words(gen, (w, 3077), cuda_device) for _ in range(n_planes))
        qs = tuple(_device_words(gen, (n_q, w), cuda_device) for _ in range(n_planes))
        for p, q in zip(planes, qs):
            p[:, 100:140] = p[:, 5:6]  # duplicate rows tie
            q[0] = p[:, 5]
        got = tpk.fused_packed_keys_batch(qs, planes, k)
        want = tpk.packed_knn_plain(qs, planes, k)
        assert all(torch.equal(x, y) for x, y in zip(got, want))

    @pytest.mark.parametrize("kind", ["binary", "ternary"])
    @pytest.mark.parametrize("w", [3, 24])
    def test_rows_match_plain_exactly(self, cuda_device, kind, w):
        gen = torch.Generator(device=cuda_device).manual_seed(8)
        a = _device_words(gen, (3077, w), cuda_device)
        planes = (a,) if kind == "binary" else (a & a.roll(1, 0), a & ~a.roll(1, 0))
        q = _device_words(gen, (w,), cuda_device)
        qs = (q,) if kind == "binary" else (q & q.roll(1), q & ~q.roll(1))
        before = th.LAUNCHES
        got = th.packed_rows(qs, planes)
        assert th.LAUNCHES > before
        assert torch.equal(got, th.hamming_rows_plain(qs, planes))
