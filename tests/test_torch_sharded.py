"""innr_tpu_torch.parallel.ShardedCorpus against innr_tpu.parallel.

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``), the
port on a mesh of ``["cpu"] * 8`` in one process: the same shard count, so
the same row ranges (the port keeps them without the JAX padding rows).
Both get the same numpy draws. Indices must be equal; scores bit for bit on
integer-valued rows (every dot and distance is then exact, and many rows
tie across shards, where the lowest global index must win), within
``cond_tol`` on Gaussian rows. Cosine on integer rows is held to the port's
own single-device scan (unit queries are not integers). The ``cuda`` class
holds a 4 x ``cuda:0`` mesh to the single-card call on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu.parallel as jp  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
import innr_tpu_torch.parallel as tp  # noqa: E402
from conftest import cond_tol  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.kernels import pruned_knn as tpk  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def cpu_mesh(n=8):
    return tp.default_mesh(["cpu"] * n)


def int_rows(rng, n, d, lo=-3, hi=4):
    return rng.integers(lo, hi, (n, d)).astype(np.float32)


def same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def np_(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


METHODS = {"dot": "knn_dot", "l2": "knn_l2", "cosine": "knn_cosine"}
FULL = {"dot": tt.batch_knn_dot, "l2": tt.batch_knn, "cosine": tt.batch_knn_cosine}


def assert_close_scores(got, want, qs, rows, idx, mode):
    """Scores within cond_tol of the pair's products (L2: of the expanded
    ``|q|^2 + |r|^2 - 2 q.r``)."""
    qs = np.atleast_2d(qs)
    got, want, idx = np.atleast_2d(got), np.atleast_2d(want), np.atleast_2d(idx)
    for qi in range(got.shape[0]):
        for j in range(got.shape[1]):
            r = rows[idx[qi, j]]
            tol = cond_tol(qs[qi], r)
            if mode == "l2":
                tol = 2 * tol + cond_tol(qs[qi], qs[qi]) + cond_tol(r, r)
            if mode == "cosine":
                tol = 64 * np.finfo(np.float32).eps
            assert abs(float(got[qi, j]) - float(want[qi, j])) <= tol, (qi, j)


class TestMesh:
    def test_default_mesh_over_given_devices(self):
        mesh = cpu_mesh()
        assert mesh.size == 8 and mesh.axis_names == ("shards",)
        assert mesh.shape == {"shards": 8}
        assert mesh.distinct() == [torch.device("cpu")]

    def test_default_mesh_follows_the_default_device(self):
        mesh = tp.default_mesh()
        assert mesh.flat() == [torch.device("cpu")]

    def test_default_mesh_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        config.set_default_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.default_mesh()

    def test_shard_ranges_are_the_jax_ranges_without_padding(self):
        from innr_tpu_torch.parallel.sharded import shard_ranges

        assert shard_ranges(9, 8) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 9), (9, 9),
                                      (9, 9), (9, 9)]
        assert shard_ranges(3, 8)[3:] == [(3, 3)] * 5
        sc = tp.ShardedCorpus(np.zeros((1001, 4), np.float32), cpu_mesh())
        js = jp.ShardedCorpus(np.zeros((1001, 4), np.float32))
        assert sc.shard_rows == js.shard_rows == 126
        assert sc.memory_bytes() == 1001 * 4 * 4  # no padding rows held


class TestShardedKnn:
    @pytest.mark.parametrize("mode", ["dot", "l2"])
    @pytest.mark.parametrize("k", [1, 7, 50, 301, 999])
    def test_integer_rows_bit_for_bit(self, rng, mode, k):
        rows, qs = int_rows(rng, 301, 16), int_rows(rng, 5, 16)
        got_v, got_i = getattr(tp.ShardedCorpus(rows, cpu_mesh()), METHODS[mode])(qs, k)
        want_v, want_i = getattr(jp.ShardedCorpus(rows), METHODS[mode])(qs, k)
        np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
        assert same_bits(np_(got_v), want_v)
        full = FULL[mode](qs, tt.VerticalBatch(rows), k)
        np.testing.assert_array_equal(np_(got_i), full.indices)
        assert same_bits(np_(got_v), full.scores)

    @pytest.mark.parametrize("k", [1, 9, 64])
    def test_integer_cosine_equals_the_single_device_scan(self, rng, k):
        rows, qs = int_rows(rng, 301, 16), int_rows(rng, 5, 16)
        rows[7] = 0.0
        got_v, got_i = tp.ShardedCorpus(rows, cpu_mesh()).knn_cosine(qs, k)
        want = tt.batch_knn_cosine(qs, tt.VerticalBatch(rows), k)
        np.testing.assert_array_equal(np_(got_i), want.indices)
        np.testing.assert_allclose(np_(got_v), want.scores, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("mode", ["dot", "l2", "cosine"])
    def test_gaussian_within_cond_tol(self, rng, mode):
        rows = rng.standard_normal((500, 48)).astype(np.float32)
        rows[11] = 0.0
        qs = rng.standard_normal((5, 48)).astype(np.float32)
        got_v, got_i = getattr(tp.ShardedCorpus(rows, cpu_mesh()), METHODS[mode])(qs, 6)
        want_v, want_i = getattr(jp.ShardedCorpus(rows), METHODS[mode])(qs, 6)
        np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
        assert_close_scores(np_(got_v), np.asarray(want_v), qs, rows, np_(got_i), mode)

    def test_ties_across_shards_go_to_the_lowest_global_index(self, rng):
        rows = int_rows(rng, 400, 8)
        q = int_rows(rng, 1, 8)[0]
        for pos in (5, 55, 105, 255, 399):  # one per shard of 50 rows, and the last
            rows[pos] = 9 * np.sign(q)
        v, i = tp.ShardedCorpus(rows, cpu_mesh()).knn_dot(q, 4)
        assert list(np_(i)) == [5, 55, 105, 255]
        assert len(set(np_(v).tolist())) == 1
        jv, ji = jp.ShardedCorpus(rows).knn_dot(q, 4)
        np.testing.assert_array_equal(np_(i), np.asarray(ji))

    @pytest.mark.parametrize("n", [1, 3, 9])
    def test_fewer_rows_than_shards(self, rng, n):
        rows, qs = int_rows(rng, n, 6), int_rows(rng, 3, 6)
        for mode in ("dot", "l2"):
            got_v, got_i = getattr(tp.ShardedCorpus(rows, cpu_mesh()), METHODS[mode])(qs, 5)
            want_v, want_i = getattr(jp.ShardedCorpus(rows), METHODS[mode])(qs, 5)
            np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
            assert same_bits(np_(got_v), want_v)

    def test_k_above_single_pass_k(self, rng, monkeypatch):
        monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
        rows, qs = int_rows(rng, 333, 8), int_rows(rng, 2, 8)
        got_v, got_i = tp.ShardedCorpus(rows, cpu_mesh()).knn_dot(qs, 40)
        want_v, want_i = jp.ShardedCorpus(rows).knn_dot(qs, 40)
        np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
        assert same_bits(np_(got_v), want_v)

    def test_nan_rows_sort_first_for_dot_and_last_for_l2(self, rng):
        rows, q = int_rows(rng, 200, 8), int_rows(rng, 1, 8)[0]
        rows[[30, 170]] = np.nan
        sc = tp.ShardedCorpus(rows, cpu_mesh())
        v, i = sc.knn_dot(q, 4)
        assert list(np_(i)[:2]) == [30, 170] and np.isnan(np_(v)[:2]).all()
        full = tt.batch_knn_dot(q, tt.VerticalBatch(rows), 4)
        np.testing.assert_array_equal(np_(i), full.indices)
        v, i = sc.knn_l2(q, 200)
        assert list(np_(i)[-2:]) == [30, 170]
        jv, ji = jp.ShardedCorpus(rows).knn_l2(q, 200)
        np.testing.assert_array_equal(np_(i), np.asarray(ji))

    def test_single_query_equals_the_batch_row(self, rng):
        rows, qs = int_rows(rng, 256, 16), int_rows(rng, 4, 16)
        sc = tp.ShardedCorpus(rows, cpu_mesh())
        bv, bi = sc.knn_l2(qs, 5)
        for j in range(4):
            v, i = sc.knn_l2(qs[j], 5)
            assert np_(i).shape == (5,)
            np.testing.assert_array_equal(np_(i), np_(bi)[j])
            assert same_bits(np_(v), np_(bv)[j])

    def test_bf16_equals_the_single_device_bf16_scan(self, rng):
        rows = rng.standard_normal((400, 32)).astype(np.float32)
        qs = rng.standard_normal((3, 32)).astype(np.float32)
        sc = tp.ShardedCorpus(rows, cpu_mesh(), dtype=torch.bfloat16)
        assert sc.memory_bytes() == 400 * 32 * 2
        vb = tt.VerticalBatch(rows, dtype=torch.bfloat16)
        for mode in ("dot", "l2"):
            v, i = getattr(sc, METHODS[mode])(qs, 5)
            want = FULL[mode](qs, vb, 5)
            np.testing.assert_array_equal(np_(i), want.indices)
        # Integer rows and queries are exact in bf16: bit for bit the JAX class.
        rows, qs = int_rows(rng, 300, 32), int_rows(rng, 3, 32)
        jv, ji = jp.ShardedCorpus(rows, dtype=jnp.bfloat16).knn_l2(qs, 5)
        v, i = tp.ShardedCorpus(rows, cpu_mesh(), dtype=torch.bfloat16).knn_l2(qs, 5)
        np.testing.assert_array_equal(np_(i), np.asarray(ji))
        assert same_bits(np_(v), jv)

    def test_edges_and_contracts(self, rng):
        rows = int_rows(rng, 10, 8)
        sc = tp.ShardedCorpus(rows, cpu_mesh())
        for m in METHODS.values():
            assert np_(getattr(sc, m)(rows[0], 0)[0]).shape == (0,)
            assert np_(getattr(sc, m)(rows[:2], 0)[0]).shape == (2, 0)
            assert np_(getattr(sc, m)(rows[0], 99)[1]).shape == (10,)
        with pytest.raises(tt.ContractError):
            sc.knn_dot(np.zeros(9, np.float32), 3)
        with pytest.raises(tt.ContractError):
            tp.ShardedCorpus(np.zeros(8, np.float32), cpu_mesh())
        with pytest.raises(tt.ContractError):
            tp.ShardedCorpus(rows, cpu_mesh(), dtype=torch.int32)
        empty = tp.ShardedCorpus(np.zeros((0, 8), np.float32), cpu_mesh())
        assert np_(empty.knn_dot(rows[:3], 4)[1]).shape == (3, 0)

    def test_module_functions_equal_the_methods(self, rng):
        rows, qs = int_rows(rng, 100, 8), int_rows(rng, 2, 8)
        sc = tp.ShardedCorpus(rows, cpu_mesh())
        for fn, m in ((tp.sharded_knn_dot, "knn_dot"), (tp.sharded_knn_l2, "knn_l2"),
                      (tp.sharded_knn_cosine, "knn_cosine")):
            a, b = fn(qs, sc, 4), getattr(sc, m)(qs, 4)
            np.testing.assert_array_equal(np_(a[1]), np_(b[1]))

    def test_tensor_rows_are_sliced_as_views(self, rng):
        rows = torch.from_numpy(int_rows(rng, 80, 8))
        sc = tp.ShardedCorpus(rows, cpu_mesh(4))
        assert sc.shards[1].rows.data_ptr() == rows[20:].data_ptr()


class TestShardedFiltered:
    def test_integer_rows_bit_for_bit(self, rng):
        rows, qs = int_rows(rng, 333, 16), int_rows(rng, 4, 16)
        mask = rng.random(333) < 0.3
        got_v, got_i = tp.ShardedCorpus(rows, cpu_mesh()).knn_filtered(qs, 9, mask)
        want_v, want_i = jp.ShardedCorpus(rows).knn_filtered(qs, 9, mask)
        np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
        assert same_bits(np_(got_v), want_v)
        assert mask[np_(got_i)].all()
        full = tt.batch_knn_filtered(qs, tt.VerticalBatch(rows), 9, mask)
        assert same_bits(np_(got_v), full.scores)

    def test_callable_and_shards_without_passing_rows(self, rng):
        rows, q = int_rows(rng, 160, 8), int_rows(rng, 1, 8)[0]
        sc = tp.ShardedCorpus(rows, cpu_mesh())  # shards of 20 rows
        pred = lambda i: 40 <= i < 60 or i == 150  # noqa: E731
        got_v, got_i = sc.knn_filtered(q, 30, pred)
        assert np_(got_i).shape == (21,)
        want_v, want_i = jp.ShardedCorpus(rows).knn_filtered(q, 30, pred)
        np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
        assert same_bits(np_(got_v), want_v)
        assert np_(tp.sharded_knn_filtered(q, sc, 5, np.zeros(160, bool))[1]).shape == (0,)
        with pytest.raises(tt.ContractError):
            sc.knn_filtered(q, 5, np.zeros(159, bool))

    def test_gaussian_within_cond_tol(self, rng):
        rows = rng.standard_normal((900, 48)).astype(np.float32)
        q = rng.standard_normal(48).astype(np.float32)
        mask = rng.random(900) < 0.3
        got_v, got_i = tp.ShardedCorpus(rows, cpu_mesh()).knn_filtered(q, 7, mask)
        want_v, want_i = jp.ShardedCorpus(rows).knn_filtered(q, 7, mask)
        np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
        assert_close_scores(np_(got_v), np.asarray(want_v), q, rows, np_(got_i), "l2")


class TestFromRowSource:
    def test_memmap_equals_the_materialised_corpus(self, rng, tmp_path):
        rows = int_rows(rng, 333, 24)
        path = tmp_path / "corpus.f32"
        rows.tofile(path)
        mm = np.memmap(path, dtype=np.float32, mode="r", shape=(333, 24))
        fetches = []

        def get_rows(start, stop):
            fetches.append((start, stop))
            return mm[start:stop]

        sc = tp.ShardedCorpus.from_row_source(get_rows, 333, 24, cpu_mesh())
        assert fetches == [(s, e) for s, e in sc.ranges if e > s]
        q = int_rows(rng, 2, 24)
        got = sc.knn_dot(q, 5)
        want = tp.ShardedCorpus(rows, cpu_mesh()).knn_dot(q, 5)
        np.testing.assert_array_equal(np_(got[1]), np_(want[1]))
        assert same_bits(np_(got[0]), np_(want[0]))
        jv, ji = jp.ShardedCorpus.from_row_source(lambda a, b: mm[a:b], 333, 24).knn_dot(q, 5)
        np.testing.assert_array_equal(np_(got[1]), np.asarray(ji))

    def test_empty_shards_never_fetch_and_bad_shapes_raise(self, rng):
        rows = int_rows(rng, 3, 4)
        calls = []
        sc = tp.ShardedCorpus.from_row_source(lambda a, b: calls.append((a, b)) or rows[a:b],
                                              3, 4, cpu_mesh())
        assert calls == [(0, 1), (1, 2), (2, 3)]
        assert int(np_(sc.knn_l2(rows[2], 1)[1])[0]) == 2
        with pytest.raises(tt.ContractError):
            tp.ShardedCorpus.from_row_source(lambda a, b: np.zeros((b - a, 5), np.float32),
                                             16, 4, cpu_mesh())


class TestShardedPruned:
    def _clustered(self, rng, n=1536, d=16):
        centers = (5.0 * rng.standard_normal((12, d))).astype(np.float32)
        assign = np.sort(rng.integers(0, 12, n))
        return (centers[assign] + 0.05 * rng.standard_normal((n, d))).astype(np.float32)

    @pytest.mark.parametrize("mode", ["dot", "l2", "cosine"])
    def test_pruned_equals_the_full_scan_and_jax(self, rng, mode, monkeypatch):
        calls = []
        real = tpk.pruned_keys
        monkeypatch.setattr(tpk, "pruned_keys", lambda *a, **kw: calls.append(1) or real(*a,
                                                                                        **kw))
        rows = self._clustered(rng)
        qs = rows[[3, 700]] + np.float32(0.01)
        sc = tp.ShardedCorpus(rows, cpu_mesh()).set_prune_tile_n(128)
        pv, pi = getattr(sc, METHODS[mode])(qs, 6, prune=True)
        assert len(calls) == 8, "every shard must take the tile scan"
        fv, fi = getattr(sc, METHODS[mode])(qs, 6)
        np.testing.assert_array_equal(np_(pi), np_(fi))
        assert same_bits(np_(pv), np_(fv))
        js = jp.ShardedCorpus(rows).set_prune_tile_n(128)
        jv, ji = getattr(js, METHODS[mode])(qs, 6, prune=True)
        np.testing.assert_array_equal(np_(pi), np.asarray(ji))

    def test_bf16_prunes_exactly(self, rng):
        rows = self._clustered(rng)
        qs = rows[[10, 1200]] + np.float32(0.02)
        sc = tp.ShardedCorpus(rows, cpu_mesh(4), dtype=torch.bfloat16).set_prune_tile_n(128)
        pv, pi = sc.knn_dot(qs, 5, prune=True)
        fv, fi = sc.knn_dot(qs, 5)
        np.testing.assert_array_equal(np_(pi), np_(fi))
        assert same_bits(np_(pv), np_(fv))

    def test_summaries_per_shard_cached_and_the_tile_knob(self, rng):
        rows = self._clustered(rng, n=1000)
        sc = tp.ShardedCorpus(rows, cpu_mesh())
        js = jp.ShardedCorpus(rows)
        summaries = sc.tile_summary()
        assert summaries is sc.tile_summary() and len(summaries) == 8
        assert summaries[0].tile_n == js.tile_summary()[3]
        assert sum(int(s.counts.sum()) for s in summaries) == 1000
        assert sc.set_prune_tile_n(130) is sc
        assert sc.tile_summary()[0].tile_n == js.set_prune_tile_n(130).tile_summary()[3] == 128
        sc.set_prune_tile_n(None)
        assert sc.tile_summary()[0].tile_n == summaries[0].tile_n
        with pytest.raises(tt.ContractError):
            sc.set_prune_tile_n(-1)

    def test_k_above_one_pass_takes_the_full_scan(self, rng, monkeypatch):
        monkeypatch.setattr(tk, "_K_MAX_PASS", 8)
        rows = self._clustered(rng, n=600)
        sc = tp.ShardedCorpus(rows, cpu_mesh(4)).set_prune_tile_n(128)
        pv, pi = sc.knn_l2(rows[:2], 20, prune=True)
        fv, fi = sc.knn_l2(rows[:2], 20)
        np.testing.assert_array_equal(np_(pi), np_(fi))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestOnCuda:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_four_same_card_shards_equal_the_single_card_call(self, cuda_device, dtype):
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        rows = torch.randn((50_001, 64), generator=gen, device=cuda_device)
        qs = torch.randn((7, 64), generator=gen, device=cuda_device)
        sc = tp.ShardedCorpus(rows, tp.default_mesh([cuda_device] * 4), dtype=dtype)
        vb = tt.VerticalBatch(rows, dtype=dtype)
        mask = (torch.rand(50_001, generator=gen, device=cuda_device) < 0.3).cpu().numpy()
        for mode in ("dot", "l2", "cosine"):
            for k in (10, 300):
                v, i = getattr(sc, METHODS[mode])(qs, k)
                want = FULL[mode](qs, vb, k)
                np.testing.assert_array_equal(i.cpu().numpy(), want.indices)
                assert same_bits(v.cpu().numpy(), want.scores), (mode, k)
        v, i = sc.knn_filtered(qs, 10, mask)
        want = tt.batch_knn_filtered(qs, vb, 10, mask)
        np.testing.assert_array_equal(i.cpu().numpy(), want.indices)
        assert same_bits(v.cpu().numpy(), want.scores)
