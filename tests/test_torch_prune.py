"""innr_tpu_torch.prune against innr_tpu.prune.

Tile summaries and survivor plans are held to the JAX package's on the same
numpy inputs; both packages are also planned from one summary
(``TileSummary.from_numpy`` of the JAX summary's arrays). k-means draws
differ between ``jax.random`` and ``torch.Generator``, so the layout passes
are held to invariants (a permutation, stable by cluster, sizes summing to
N) and to a seeded clustered corpus whose clusters they must recover.

Tolerances: centroids and radii within cond_tol (32 eps times the summed
magnitudes); counts and plans exact, on data whose bound margins exceed the
planner's slack.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
from innr_tpu import prune as jp  # noqa: E402
from innr_tpu.kernels import pruned_knn as jpk  # noqa: E402
from innr_tpu_torch import config as tconfig  # noqa: E402
from innr_tpu_torch import prune as tp  # noqa: E402
from innr_tpu_torch.kernels import pruned_knn as tpk  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(previous)


EPS = float(np.finfo(np.float32).eps)


def clustered(rng, n=3000, d=24, n_centers=16, noise=0.05, sort=True):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3
    assign = rng.integers(0, n_centers, n)
    if sort:
        assign = np.sort(assign)
    return (centers[assign] + noise * rng.standard_normal((n, d))).astype(np.float32)


def summaries(rows, tile_n, **kw):
    js = jp.build_tile_summary(jnp.asarray(rows), tile_n, **kw)
    kw_t = dict(kw)
    if "row_valid" in kw_t:
        kw_t["row_valid"] = torch.from_numpy(np.asarray(kw_t["row_valid"]))
    ts = tp.build_tile_summary(torch.from_numpy(rows), tile_n, **kw_t)
    return js, ts


def assert_summaries_agree(js, ts, rows):
    assert ts.tile_n == js.tile_n and ts.n_tiles == js.n_tiles and ts.n_rows == js.n_rows
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    scale = 32 * EPS * (np.abs(rows).max() + 1.0) * rows.shape[1]
    jc, jr = np.asarray(js.centroids), np.asarray(js.radii)
    np.testing.assert_allclose(ts.centroids.numpy(), jc, rtol=0, atol=scale)
    np.testing.assert_allclose(ts.radii.numpy(), jr, rtol=0, atol=scale, equal_nan=True)
    assert ts.memory_bytes() == js.memory_bytes()


class TestTileSummary:
    def test_plain_and_ragged_tail(self, rng):
        rows = rng.standard_normal((700, 8)).astype(np.float32)
        js, ts = summaries(rows, 256)
        assert ts.counts.tolist() == [256, 256, 188]
        assert_summaries_agree(js, ts, rows)

    def test_normalized(self, rng):
        rows = clustered(rng, n=900, d=16)
        rows[7] = 0.0  # zero row -> zero unit row
        js, ts = summaries(rows, 128, normalized=True)
        assert_summaries_agree(js, ts, np.ones_like(rows))

    def test_row_valid(self, rng):
        rows = rng.standard_normal((640, 12)).astype(np.float32)
        valid = rng.random(640) < 0.7
        valid[256:384] = False  # a tile with no valid row: count 0
        rows[~valid] = 1e3      # padding values must not move any summary
        js, ts = summaries(rows, 128, row_valid=valid)
        assert int(ts.counts[2]) == 0
        assert_summaries_agree(js, ts, np.where(valid[:, None], rows, 0.0))

    def test_nan_row_poisons_its_tile_radius(self, rng):
        rows = rng.standard_normal((600, 8)).astype(np.float32)
        rows[300] = np.nan
        js, ts = summaries(rows, 256)
        assert np.isnan(float(ts.radii[1])) and np.isnan(np.asarray(js.radii)[1])
        assert not np.isnan(ts.radii[[0, 2]].numpy()).any()
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))

    def test_chunked_pass_equals_one_block(self, rng, monkeypatch):
        rows = torch.from_numpy(rng.standard_normal((1000, 6)).astype(np.float32))
        one = tp.build_tile_summary(rows, 128)
        monkeypatch.setattr(tp, "_SUMMARY_CHUNK", 128 * 6 * 3)  # 3 tiles a chunk
        many = tp.build_tile_summary(rows, 128)
        for a, b in ((one.centroids, many.centroids), (one.radii, many.radii),
                     (one.counts, many.counts)):
            assert torch.equal(a, b)

    def test_from_numpy_takes_the_jax_summary(self, rng):
        rows = rng.standard_normal((500, 4)).astype(np.float32)
        js = jp.build_tile_summary(jnp.asarray(rows), 128)
        ts = tt.TileSummary.from_numpy(js.tile_n, js.centroids, js.radii, js.counts, js.n_rows)
        assert ts.centroids.dtype == torch.float32 and ts.counts.dtype == torch.int32
        np.testing.assert_array_equal(ts.centroids.numpy(), np.asarray(js.centroids))
        assert ts.n_tiles == 4


def plans(js, qs, k, mode, fast):
    jo, jn = jp.plan_survivors(jnp.asarray(qs), js.centroids, js.radii, js.counts, k, mode,
                               fast=fast)
    ts = tt.TileSummary.from_numpy(js.tile_n, js.centroids, js.radii, js.counts, js.n_rows)
    to, tn = tp.plan_survivors(torch.from_numpy(qs), ts.centroids, ts.radii, ts.counts, k,
                               mode, fast=fast)
    return (np.asarray(jo), int(jn)), (to, tn)


class TestPlans:
    @pytest.mark.parametrize("fast", [False, True])
    @pytest.mark.parametrize("mode", ["dot", "l2"])
    def test_plan_survivors_equal(self, rng, mode, fast):
        rows = clustered(rng, n=4096, d=32)
        js = jp.build_tile_summary(jnp.asarray(rows), 256)
        qs = (rows[[10, 20, 30]] + 0.01).astype(np.float32)
        (jo, jn), (to, tn) = plans(js, qs, 5, mode, fast)
        assert to.dtype == torch.int32 and tn.dtype == torch.int32 and tn.dim() == 0
        assert 0 < int(tn) < js.n_tiles
        assert int(tn) == jn
        np.testing.assert_array_equal(to.numpy(), jo)
        o = to.numpy()
        assert np.all(np.diff(o[:jn]) > 0) and np.all(o[jn:] == o[jn - 1])

    def test_own_summary_plans_like_jax(self, rng):
        rows = clustered(rng, n=4096, d=32)
        js, ts = summaries(rows, 256)
        qs = (rows[[5, 3000]] + 0.01).astype(np.float32)
        jo, jn = jp.plan_survivors(jnp.asarray(qs), js.centroids, js.radii, js.counts, 7, "l2")
        to, tn = tp.plan_survivors(torch.from_numpy(qs), ts.centroids, ts.radii, ts.counts, 7,
                                   "l2")
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))

    def test_nan_tile_stays_alive_and_empty_tiles_die(self, rng):
        rows = clustered(rng, n=2048, d=16)
        rows[1500] = np.nan
        valid = np.ones(2048, bool)
        valid[:256] = False
        js, ts = summaries(rows, 256, row_valid=valid)
        qs = rng.standard_normal((1, 16)).astype(np.float32)
        to, tn = tp.plan_survivors(torch.from_numpy(qs), ts.centroids, ts.radii, ts.counts, 3,
                                   "dot")
        live = to[: int(tn)].tolist()
        assert 1500 // 256 in live and 0 not in live

    def test_threshold_plan_equal(self, rng):
        rows = clustered(rng, n=4096, d=32)
        js = jp.build_tile_summary(jnp.asarray(rows), 256)
        ts = tt.TileSummary.from_numpy(js.tile_n, js.centroids, js.radii, js.counts, js.n_rows)
        q = (rows[100] + 0.01).astype(np.float32)
        jo, jn, ja = jp.plan_threshold_survivors(jnp.asarray(q[None]), js.centroids, js.radii,
                                                 np.float32(1.0))
        to, tn, ta = tp.plan_threshold_survivors(torch.from_numpy(q[None]), ts.centroids,
                                                 ts.radii, 1.0)
        assert 0 < int(tn) < ts.n_tiles
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


class TestTileHeights:
    @pytest.mark.parametrize("n,d", [(100, 8), (4096, 16), (60_000, 128), (10_000_000, 128),
                                     (1_000_000, 768)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_pruned_tile_n_equal(self, n, d, dtype):
        jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                             torch.float32)
        assert tpk.pruned_tile_n(n, d, td) == jpk.pruned_tile_n(n, d, jd)

    @pytest.mark.parametrize("sizes,n,d", [
        (np.full(100, 600), 60_000, 128), (np.full(100, 8000), 800_000, 128),
        (np.full(10, 40), 400, 8), (np.zeros(5, np.int64), 1_000_000, 128),
        (np.full(3, 10**9), 1_000_000, 128), (np.arange(1, 300) * 97, 10_000_000, 128),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_suggest_tile_n_equal(self, sizes, n, d, dtype):
        jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                             torch.float32)
        assert tp.suggest_tile_n(sizes, n, d, td) == jp.suggest_tile_n(sizes, n, d, jd)
        assert tp.suggest_tile_n(torch.from_numpy(sizes), n, d, td) == tp.suggest_tile_n(
            sizes, n, d, td)

    def test_set_prune_tile_n(self, rng):
        rows = rng.standard_normal((4096, 16)).astype(np.float32)
        vb, jb = tt.VerticalBatch(rows), it.VerticalBatch.from_rows(rows)
        default = tpk.pruned_tile_n(4096, 16, torch.float32)
        with pytest.raises(tt.ContractError):
            vb.set_prune_tile_n(0)
        for tile in (300, 10**9, None, 256):
            assert vb.set_prune_tile_n(tile) is vb
            jb.set_prune_tile_n(tile)
            assert vb.tile_summary().tile_n == jb.tile_summary().tile_n
        assert vb.tile_summary().tile_n == 256
        vb.set_prune_tile_n(None)
        assert vb.tile_summary().tile_n == vb.tile_summary(normalized=True).tile_n == default


class TestRouteConfig:
    def test_validation_and_default(self):
        assert tconfig.prune_route_min_elide() == 0.10
        assert tconfig.PRUNE_BOUND_EPS == it.config.PRUNE_BOUND_EPS
        for bad in (-0.1, 1.5, float("nan")):
            with pytest.raises(ValueError):
                tconfig.set_prune_route_min_elide(bad)

    @pytest.mark.parametrize("fraction", [0.0, 0.10, 1.0])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_route_on_the_device(self, rng, monkeypatch, fraction, dtype):
        """The plan the pruned scan reads stands whatever the routing
        threshold (no router here): the survivor plan of the scored query
        (bf16-rounded against a bf16 corpus), as device tensors."""
        monkeypatch.setattr(tconfig, "_PRUNE_ROUTE_MIN_ELIDE", fraction)
        vb = tt.VerticalBatch(clustered(rng), dtype=dtype).set_prune_tile_n(128)
        s = vb.tile_summary()
        qs = vb.rows[[3, 1500]].float() + 0.01
        order, n_surv = tpk.plan(qs, vb.rows, s, 5, "l2")
        q_plan = qs.to(dtype).float()
        want = tp.plan_survivors(q_plan, s.centroids, s.radii, s.counts, 5, "l2",
                                 fast=tpk._fast_plan_ok(5, s))
        assert torch.is_tensor(n_surv) and n_surv.device == qs.device
        assert 0 < int(n_surv) < s.n_tiles
        assert torch.equal(order, want[0]) and torch.equal(n_surv, want[1])


class TestLayoutPasses:
    def test_cluster_reorder_invariants(self, rng):
        rows = clustered(rng, n=4096, d=32, sort=False)
        reordered, perm, sizes = tp.cluster_reorder(rows, n_clusters=16, n_iters=4)
        p = perm.numpy()
        assert perm.dtype == torch.int32 and sizes.dtype == torch.int32
        assert sorted(p.tolist()) == list(range(4096))
        np.testing.assert_array_equal(reordered.numpy(), rows[p])
        assert int(sizes.sum()) == 4096 and sizes.shape == (16,)
        np.testing.assert_array_equal(p, tp.cluster_order(rows, n_clusters=16, n_iters=4))
        # Stable by cluster: within one cluster, corpus order.
        bounds = np.concatenate([[0], np.cumsum(sizes.numpy())])
        for a, b in zip(bounds[:-1], bounds[1:]):
            assert np.all(np.diff(p[a:b]) > 0)

    def test_layout_recovers_separated_clusters(self, rng):
        """Each recovered cluster holds one true cluster's rows: the
        assignment the port's k-means finds is the JAX one up to labels."""
        n, nc = 4096, 8
        centers = 10 * rng.standard_normal((nc, 16)).astype(np.float32)
        truth = rng.integers(0, nc, n)
        rows = (centers[truth] + 0.05 * rng.standard_normal((n, 16))).astype(np.float32)
        _, perm, sizes = tp.cluster_reorder(rows, n_clusters=nc, n_iters=5)
        jr, jperm, jsizes = jp.cluster_reorder(rows, n_clusters=nc, n_iters=5)
        assert sorted(sizes.tolist()) == sorted(np.asarray(jsizes).tolist())
        bounds = np.concatenate([[0], np.cumsum(sizes.numpy())])
        for a, b in zip(bounds[:-1], bounds[1:]):
            assert len(set(truth[perm.numpy()[a:b]].tolist())) <= 1

    def test_batch_cluster_reorder_and_pruned_scan(self, rng):
        """About 3000 rows a cluster at d=128: the suggested tile (the
        2048-row floor) is below the default height, and the reordered
        batch prunes, with results mapped back through perm equal to the
        full scan's."""
        n, d, nc = 60_000, 128, 20
        centers = 6.0 * rng.standard_normal((nc, d)).astype(np.float32)
        rows = (centers[rng.integers(0, nc, n)]
                + 0.05 * rng.standard_normal((n, d))).astype(np.float32)
        vb = tt.VerticalBatch(rows)
        nb, perm = vb.cluster_reorder(n_clusters=nc, n_iters=3)
        p = perm.numpy()
        np.testing.assert_array_equal(nb.rows.numpy(), rows[p])
        sizes = np.bincount(tp._kmeans_assign(vb.rows, 0, 3, nc, n).numpy(), minlength=nc)
        assert nb.tile_summary().tile_n == tp.suggest_tile_n(sizes, n, d) == 2048
        assert nb.tile_summary().tile_n < tpk.pruned_tile_n(n, d)
        qs = (centers[:3] + 0.01).astype(np.float32)
        s = nb.tile_summary()
        _, ns = tp.plan_survivors(torch.from_numpy(qs), s.centroids, s.radii, s.counts, 5, "l2")
        assert int(ns) < 0.75 * s.n_tiles
        full = tt.batch_knn(qs, vb, 5)
        pruned = tt.batch_knn(qs, nb, 5, prune=True)
        np.testing.assert_array_equal(p[pruned.indices], full.indices)
        np.testing.assert_allclose(pruned.scores, full.scores, rtol=1e-5, atol=1e-5)

    def test_bf16_reorder_keeps_dtype(self, rng):
        rows = clustered(rng, n=2048, d=16, sort=False)
        vb = tt.VerticalBatch(rows, dtype=torch.bfloat16)
        nb, perm = vb.cluster_reorder(n_clusters=8, n_iters=2)
        assert nb.rows.dtype == torch.bfloat16
        assert torch.equal(nb.rows, vb.rows[perm.long()])

    def test_kmeans_params_clamp(self, rng):
        rows = rng.standard_normal((50, 4)).astype(np.float32)
        r, kc, m = tp._kmeans_params(rows, 256, 65536)
        assert (kc, m) == (50, 50) and isinstance(r, torch.Tensor)
        order = tp.cluster_order(rows, n_clusters=256, n_iters=1)
        assert sorted(order.tolist()) == list(range(50))

    def test_nan_row_does_not_break_the_fit(self, rng):
        rows = clustered(rng, n=1024, d=8, sort=False)
        rows[17] = np.nan
        order = tp.cluster_order(rows, n_clusters=4, n_iters=2)
        assert sorted(order.tolist()) == list(range(1024))

    @pytest.mark.parametrize("chunk", [1, 5, 64])
    def test_seeding_in_chunks_equals_single_steps(self, rng, monkeypatch, chunk):
        """The seeding's chunk (the CUDA graph's unit) does not change the
        seeds: kmeanspp_seed in chunks equals the same steps run one at a
        time on fresh buffers from the same draws."""
        ss = torch.from_numpy(clustered(rng, n=500, d=12, sort=False))
        ss[7] = float("nan")  # a NaN row weighs as 0
        kc = 37
        monkeypatch.setattr(tp, "SEED_CHUNK", chunk)
        got = tp.kmeanspp_seed(ss, torch.Generator().manual_seed(5), kc)
        gen = torch.Generator().manual_seed(5)
        first = torch.randint(0, 500, (1,), generator=gen)
        u = torch.zeros(kc, dtype=torch.float64)
        u[1:] = torch.rand(kc - 1, generator=gen, dtype=torch.float64)
        ssn = (ss * ss).sum(dim=1)
        cent = torch.zeros((kc, 12))
        cent[0] = ss[first[0]]
        mind2 = tp._d2_to(ss, ssn, cent[0])
        j = torch.ones(1, dtype=torch.int64)
        for _ in range(kc - 1):
            tp._seed_steps(ss, ssn, u, cent, mind2, j, 1)
        assert got.shape == (kc, 12) and torch.equal(got, cent)
        assert not torch.isnan(got).any()  # the NaN row is never drawn

    def test_seeding_draws_by_distance(self):
        """Inverse CDF of the squared distances: duplicates of a chosen
        seed weigh 1e-30 and are not drawn again while distinct rows
        remain."""
        base = torch.eye(6) * 10
        ss = torch.cat([base, base, base])
        cent = tp.kmeanspp_seed(ss, torch.Generator().manual_seed(0), 6)
        assert sorted(int(torch.nonzero(c)[0]) for c in cent) == list(range(6))

    def test_cluster_order_deterministic_for_a_seed(self, rng):
        rows = clustered(rng, n=2048, d=16, sort=False)
        a = tp.cluster_order(rows, n_clusters=24, n_iters=2, seed=3)
        np.testing.assert_array_equal(a, tp.cluster_order(rows, n_clusters=24, n_iters=2,
                                                          seed=3))
        assert sorted(a.tolist()) == list(range(2048))

    def test_single_cluster_has_no_seeding_step(self, rng):
        rows = clustered(rng, n=300, d=8, sort=False)
        _, perm, sizes = tp.cluster_reorder(rows, n_clusters=1, n_iters=1)
        assert sizes.tolist() == [300] and perm.tolist() == list(range(300))

    def test_bf16_rows_into_the_summary(self, rng):
        rows = rng.standard_normal((700, 8)).astype(np.float32)
        jb = jnp.asarray(rows.astype(ml_dtypes.bfloat16))
        js = jp.build_tile_summary(jb, 256)
        ts = tp.build_tile_summary(torch.from_numpy(rows).to(torch.bfloat16), 256)
        assert_summaries_agree(js, ts, rows)
