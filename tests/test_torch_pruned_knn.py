"""innr_tpu_torch.kernels.pruned_knn and the prune=True paths against
innr_tpu.

The JAX tile scans run as the JAX package's own tests run them on the CPU:
the static-grid twins ``_pruned_raw`` / ``_threshold_raw`` in interpret
mode. The public calls use N >= MIN_ROWS_PALLAS (2048) plus a ragged tail,
so that the JAX package takes its kernel path, and a tile height of 256, so
that clustered corpora prune.

Tolerances:
- integer-valued data: raw keys and indices exact (every score is exact);
- cosine (unit queries): scores within 1e-5, indices equal where the gap
  exceeds it;
- Gaussian / clustered data: indices equal to the port's own full scan and
  to JAX's, scores equal to the port's full scan bit for bit and within
  cond_tol (32 eps sum|q_i r_i|, plus the L2 decomposition's terms) of
  JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
from innr_tpu.kernels import knn as jk  # noqa: E402
from innr_tpu.kernels import pruned_knn as jpk  # noqa: E402
from innr_tpu_torch import config as tconfig  # noqa: E402
from innr_tpu_torch import prune as tp  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.kernels import pruned_knn as tpk  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(previous)


N = 2100  # >= innr_tpu.config.MIN_ROWS_PALLAS, ragged against every tile height
EPS = float(np.finfo(np.float32).eps)
MODES = ("dot", "l2", "cosine", "dotm", "l2m", "cosinem")


def clustered(rng, n=N, d=32, n_centers=6, noise=0.05, sort=True):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3
    assign = rng.integers(0, n_centers, n)
    if sort:
        assign = np.sort(assign)
    return (centers[assign] + noise * rng.standard_normal((n, d))).astype(np.float32)


def as_jax(rows, dtype):
    return jnp.asarray(rows.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else rows)


def as_torch(rows, dtype):
    t = torch.from_numpy(np.ascontiguousarray(rows))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def aux_pair(mode, jr, tr, mask):
    r = jr.astype(jnp.float32)
    jn2, tn2 = jnp.sum(r * r, axis=1), tk._norms2(tr)
    jinv, tinv = jk.inv_norms(jr), tk.inv_norms(tr)
    jm, tm = jnp.asarray(mask, jnp.float32), torch.from_numpy(mask.astype(np.float32))
    return {
        "dot": (None, None), "l2": (jn2, tn2), "cosine": (jinv, tinv), "dotm": (jm, tm),
        "l2m": (jnp.stack([jn2, jm]), torch.stack([tn2, tm])),
        "cosinem": (jnp.stack([jinv, jm]), torch.stack([tinv, tm])),
    }[mode]


def plan_from(alive):
    """(order, n_surv) of a tile mask, for both packages."""
    order, n_surv = tp._survivor_order(torch.from_numpy(alive), alive.size)
    return (jnp.asarray(order.numpy()), jnp.asarray(int(n_surv), jnp.int32)), (order, n_surv)


def key_scores(keys, mode):
    keys = np.array(keys)
    if mode in ("l2", "l2m"):
        keys = ~keys
    return tk.invert_total_key(torch.from_numpy(keys)).numpy()


def assert_topk_agrees(vals, idx, want_vals, want_idx, tol):
    v, w = np.atleast_2d(np.asarray(vals, np.float64)), np.atleast_2d(np.asarray(want_vals,
                                                                                  np.float64))
    i, wi = np.atleast_2d(np.asarray(idx)), np.atleast_2d(np.asarray(want_idx))
    tol = np.broadcast_to(np.asarray(tol, np.float64).reshape(-1, 1), (w.shape[0], 1))
    same = (np.isnan(v) & np.isnan(w)) | (np.abs(v - w) <= tol) | (v == w)
    assert same.all(), f"scores differ: {v[~same]} vs {w[~same]}"
    gaps = np.abs(np.diff(w, axis=1))
    inf = np.full((w.shape[0], 1), np.inf)
    sep = (np.concatenate([inf, gaps], 1) > 2 * tol) & (np.concatenate([gaps, inf], 1) > 2 * tol)
    np.testing.assert_array_equal(i[sep], wi[sep])


class TestTileScanAgainstJax:
    """The plain tile scan against the JAX static twin ``_pruned_raw``,
    given the same plan."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("mode", MODES)
    def test_every_mode(self, rng, mode, dtype):
        rows = rng.integers(-4, 5, (N, 9)).astype(np.float32)
        rows[11] = np.nan
        rows[[300, 1500]] = rows[40]  # duplicates across tiles: lowest row first
        qs = rng.integers(-4, 5, (3, 9)).astype(np.float32)
        qs[0] = rows[40]
        mask = rng.random(N) < 0.6
        jr, tr = as_jax(rows, dtype), as_torch(rows, dtype)
        jq, tq = jnp.asarray(qs), torch.from_numpy(qs)
        if mode.startswith("cos"):
            jq, tq = jk._unit_queries(jq), tk._unit_queries(tq)
        alive = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1], bool)  # 9 tiles of 256
        (jo, jn), (to, tn) = plan_from(alive)
        ja, ta = aux_pair(mode, jr, tr, mask)
        jkeys, jidx = jpk._pruned_raw(jq, jr, ja, jo, jn, 7, mode, 256)
        tkeys, tidx = tpk.pruned_keys(tq, tr, ta, to, tn, 256, 7, mode)
        if mode.startswith("cos"):
            assert_topk_agrees(key_scores(tkeys, mode), tidx, key_scores(jkeys, mode), jidx, 1e-5)
        else:
            np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        live_rows = np.repeat(alive, 256)[:N]
        assert live_rows[tidx.numpy()[tidx.numpy() >= 0]].all()

    @pytest.mark.parametrize("plan", ["none", "one", "all"])
    def test_planted_plans(self, rng, plan):
        rows = rng.integers(-4, 5, (N, 5)).astype(np.float32)
        qs = rng.integers(-4, 5, (2, 5)).astype(np.float32)
        alive = {"none": np.zeros(9, bool), "one": np.eye(9, dtype=bool)[4],
                 "all": np.ones(9, bool)}[plan]
        (jo, jn), (to, tn) = plan_from(alive)
        jkeys, jidx = jpk._pruned_raw(jnp.asarray(qs), jnp.asarray(rows), None, jo, jn, 5,
                                      "dot", 256)
        tkeys, tidx = tpk.pruned_keys(torch.from_numpy(qs), torch.from_numpy(rows), None, to,
                                      tn, 256, 5, "dot")
        np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
        if plan == "none":
            # Every slot empty: key INT32_MIN in both; the port's empty slot
            # carries row -1 (K1's convention), the JAX kernel's row 0.
            assert (tkeys == torch.iinfo(torch.int32).min).all() and (tidx == -1).all()
        else:
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        if plan == "all":
            full = tk.fused_knn_keys_batch(torch.from_numpy(qs), torch.from_numpy(rows), None,
                                           5, "dot")
            assert torch.equal(full[0], tkeys) and torch.equal(full[1], tidx)

    @pytest.mark.parametrize("tile_n", [128, 200, 4736])
    def test_any_tile_height_equals_the_full_scan(self, rng, tile_n):
        rows = torch.from_numpy(rng.integers(-4, 5, (N, 6)).astype(np.float32))
        qs = torch.from_numpy(rng.integers(-4, 5, (4, 6)).astype(np.float32))
        n_tiles = -(-N // tile_n)
        order = torch.arange(n_tiles, dtype=torch.int32)
        got = tpk.pruned_keys(qs, rows, tk._norms2(rows), order, n_tiles, tile_n, 9, "l2")
        want = tk.fused_knn_keys_batch(qs, rows, tk._norms2(rows), 9, "l2")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


class TestThresholdAgainstJax:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_static_twin(self, rng, dtype):
        """The JAX threshold dot takes the f32 query against the widened
        rows, for bf16 too (not K1's rounded query): held here with a
        query off the bf16 grid."""
        rows = rng.integers(-4, 5, (N, 16)).astype(np.float32)
        q = (1.3 * rng.standard_normal(16)).astype(np.float32)
        jr, tr = as_jax(rows, dtype), as_torch(rows, dtype)
        jn2, tn2 = jnp.sum(jr.astype(jnp.float32) ** 2, axis=1), tk._norms2(tr)
        alive = np.array([0, 1, 1, 0, 0, 1, 0, 0, 1], bool)
        (jo, jn), (to, tn) = plan_from(alive)
        want = np.asarray(jpk._threshold_raw(jnp.asarray(q), jr, jn2, jo, jn, 256))[:N]
        got = tpk.threshold_dists(torch.from_numpy(q), tr, tn2, to, tn, 256).numpy()
        live = np.repeat(alive, 256)[:N]
        tol = 32 * EPS * (np.abs(rows) @ np.abs(q) + (rows * rows).sum(1))
        np.testing.assert_array_less(np.abs(got[live] - want[live]), tol[live] + 1e-6)
        assert np.isinf(got[~live]).all() and (got[~live] > 0).all()
        rounded = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
        off = tn2.numpy() - 2 * rows.astype(np.float64) @ rounded.astype(np.float64)
        if dtype == "bfloat16":
            assert np.abs(got[live] - off[live]).max() > 1e-2  # not the rounded query

    def test_plain_chunks(self, rng, monkeypatch):
        rows = torch.from_numpy(rng.standard_normal((700, 5)).astype(np.float32))
        q = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
        order = torch.tensor([0, 2, 2], dtype=torch.int32)
        one = tpk.threshold_plain(q, rows, tk._norms2(rows), order, 2, 256)
        monkeypatch.setattr(tpk, "_PLAIN_CHUNK", 5 * 100)
        assert torch.equal(tpk.threshold_plain(q, rows, tk._norms2(rows), order, 2, 256), one)
        assert torch.isinf(one[256:512]).all() and torch.isfinite(one[:256]).all()


def batches(rows, dtype="float32", tile_n=256):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jb = it.VerticalBatch(rows, dtype=jdt).set_prune_tile_n(tile_n)
    tb = tt.VerticalBatch(rows, dtype=tdt).set_prune_tile_n(tile_n)
    return jb, tb


def cond_tols(qs, rows):
    qs = np.atleast_2d(qs).astype(np.float64)
    dot = 32 * EPS * (np.abs(qs) @ np.abs(rows.astype(np.float64)).T).max(axis=1)
    l2 = 32 * EPS * ((rows.astype(np.float64) ** 2).sum(1).max() + (qs * qs).sum(1)) + 2 * dot
    return {"dot": dot, "l2": l2, "cosine": np.full(len(qs), 1e-5)}


FUNCS = {"dot": ("batch_knn_dot", tt.batch_knn_dot), "l2": ("batch_knn", tt.batch_knn),
         "cosine": ("batch_knn_cosine", tt.batch_knn_cosine)}


class TestPublicPrune:
    @pytest.mark.parametrize("single", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
    def test_prune_equals_full_scan_and_jax(self, rng, metric, dtype, single):
        rows = clustered(rng)
        qs = (rows[[5, 9, 13]] + 0.01).astype(np.float32)
        q = qs[0] if single else qs
        jb, tb = batches(rows, dtype)
        name, fn = FUNCS[metric]
        got = fn(q, tb, 6, prune=True)
        full = fn(q, tb, 6)
        want = getattr(it, name)(q, jb, 6, prune=True)
        assert got.indices.shape == ((6,) if single else (3, 6))
        np.testing.assert_array_equal(got.indices, full.indices)
        np.testing.assert_array_equal(got.scores, full.scores)
        tol = cond_tols(q, np.asarray(jb.rows.astype(jnp.float32)))[metric]
        assert_topk_agrees(got.scores, got.indices, want.scores, want.indices,
                           tol[0] if single else tol)
        s = tb.tile_summary(normalized=metric == "cosine")
        plan_q = tk._unit_queries(torch.from_numpy(qs)) if metric == "cosine" else \
            torch.from_numpy(qs)
        _, ns = tp.plan_survivors(plan_q, s.centroids, s.radii, s.counts, 6,
                                  "l2" if metric == "l2" else "dot")
        assert int(ns) < s.n_tiles  # the plan really skips tiles

    def test_bf16_plans_against_the_rounded_query(self):
        """The JAX package's adversarial case: an f32 plan would drop the
        tile of the true top-1 of the bf16 scan."""
        half = 128
        q = np.concatenate([np.full(half, 1.0039, np.float32), np.full(half, 1.00391, np.float32)])
        u = np.concatenate([np.ones(half, np.float32), np.zeros(half, np.float32)])
        v = np.concatenate([np.zeros(half, np.float32), np.full(half, 0.99609375, np.float32)])
        rows = torch.from_numpy(np.stack([u] * 8 + [v] * 8)).to(torch.bfloat16)
        s = tp.build_tile_summary(rows, 8)
        pv, pi = tpk.fused_knn_dot_pruned_batch(torch.from_numpy(q[None]), rows, s, 1)
        fv, fi = tk.fused_knn_dot_batch(torch.from_numpy(q[None]), rows, 1)
        assert torch.equal(pi, fi) and torch.equal(pv, fv) and int(fi[0, 0]) >= 8

    def test_cosine_nan_row_sorts_first_like_the_jax_kernel_path(self, rng):
        """R4: the pruned cosine scan follows K1 and the JAX kernel paths:
        a NaN row scores NaN and sorts first."""
        rows = clustered(rng)
        rows[700] = np.nan
        qs = (rows[[5, 1200]] + 0.01).astype(np.float32)
        jb, tb = batches(rows)
        got = tt.batch_knn_cosine(qs, tb, 4, prune=True)
        want = it.batch_knn_cosine(qs, jb, 4, prune=True)
        assert (got.indices[:, 0] == 700).all() and np.isnan(got.scores[:, 0]).all()
        np.testing.assert_array_equal(got.indices, want.indices)
        assert_topk_agrees(got.scores, got.indices, want.scores, want.indices, 1e-5)
        full = tt.batch_knn_cosine(qs, tb, 4)
        np.testing.assert_array_equal(got.indices, full.indices)

    def test_k_above_the_pass_cap_runs_the_full_multi_pass_scan(self, rng, monkeypatch):
        monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
        rows = clustered(rng, n=600, d=8)
        qs = torch.from_numpy((rows[:2] + 0.01).astype(np.float32))
        tr = torch.from_numpy(rows)
        s = tp.build_tile_summary(tr, 128)
        calls = []
        real = tpk.pruned_keys
        monkeypatch.setattr(tpk, "pruned_keys", lambda *a: calls.append(a) or real(*a))
        pv, pi = tpk.fused_knn_l2_pruned_batch(qs, tr, s, 40)
        fv, fi = tk.fused_knn_l2_batch(qs, tr, 40)
        assert calls == []
        assert torch.equal(pi, fi) and torch.equal(pv, fv) and (pv >= 0).all()

    def test_summary_must_cover_the_corpus(self, rng):
        rows = torch.from_numpy(rng.standard_normal((600, 4)).astype(np.float32))
        s = tp.build_tile_summary(rows[:300], 128)
        with pytest.raises(ValueError, match="cover"):
            tpk.fused_knn_dot_pruned_batch(rows[:2], rows, s, 3)

    def test_tile_scan_contracts(self):
        rows, qs = torch.ones(300, 4), torch.ones(1, 4)
        order = torch.arange(3, dtype=torch.int32)
        with pytest.raises(ContractError, match="k=301"):
            tpk.pruned_keys(qs, rows, None, order, 3, 128, 301, "dot")
        with pytest.raises(ContractError, match="cover"):
            tpk.pruned_keys(qs, rows, None, order[:2], 2, 128, 3, "dot")
        with pytest.raises(ContractError, match="unsupported device"):
            tpk.pruned_keys(qs.to("meta"), rows.to("meta"), None, order.to("meta"), 3, 128, 3,
                            "dot")


class TestRouter:
    @pytest.mark.parametrize("fraction", [0.0, 1.0])
    def test_both_routes_equal_the_full_scan(self, rng, monkeypatch, fraction):
        rows = clustered(rng)
        qs = (rows[[3, 1000]] + 0.01).astype(np.float32)
        jb, tb = batches(rows)
        seen = []
        real = tpk.pruned_keys

        def spy(qs_, rows_, aux, order, n_surv, *rest):
            seen.append(int(torch.as_tensor(n_surv).reshape(-1)[0]))
            return real(qs_, rows_, aux, order, n_surv, *rest)

        monkeypatch.setattr(tpk, "pruned_keys", spy)
        monkeypatch.setattr(tconfig, "_PRUNE_ROUTE_MIN_ELIDE", fraction)
        got = tt.batch_knn(qs, tb, 5, prune=True)
        want = tt.batch_knn(qs, tb, 5)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.scores, want.scores)
        # No router here: the plan stands whatever the threshold.
        assert len(seen) == 1 and 0 < seen[0] < tb.tile_summary().n_tiles
        jax_old = it.config.prune_route_min_elide()
        try:
            it.config.set_prune_route_min_elide(fraction)
            j = it.batch_knn(qs, jb, 5, prune=True)
        finally:
            it.config.set_prune_route_min_elide(jax_old)
        np.testing.assert_array_equal(got.indices, j.indices)


class TestThresholdAndVariants:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_batch_l2_squared_pruning(self, rng, dtype):
        rows = clustered(rng)
        q = (rows[100] + 0.01).astype(np.float32)
        jb, tb = batches(rows, dtype)
        r64 = np.asarray(jb.rows.astype(jnp.float32), np.float64)
        l2 = ((r64 - q) ** 2).sum(1)
        thr = 1.0  # the query's own cluster: about 0.08 in, above 50 out
        assert ((l2 < thr - 0.1) | (l2 > thr + 0.1)).all()
        ti, td = tt.batch_l2_squared_pruning(q, tb, thr)
        ji, jd = it.batch_l2_squared_pruning(q, jb, thr)
        assert ti.dtype == np.int64 and td.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ti, np.nonzero(l2 <= thr)[0])
        tol = 32 * EPS * ((r64 * r64).sum(1) + (q * q).sum() + 2 * np.abs(r64) @ np.abs(q))
        np.testing.assert_array_less(np.abs(td - jd), tol[ti])
        np.testing.assert_array_less(np.abs(td - l2[ti]), tol[ti])
        plan = tp.plan_threshold_survivors(torch.from_numpy(q[None]),
                                           tb.tile_summary().centroids,
                                           tb.tile_summary().radii, thr)
        assert int(plan[1]) < tb.tile_summary().n_tiles

    def test_pruning_edges(self, rng):
        rows = rng.standard_normal((300, 4)).astype(np.float32)
        rows[7] = np.nan
        tb = tt.VerticalBatch(rows).set_prune_tile_n(128)
        idx, d = tt.batch_l2_squared_pruning(rows[7], tb, 1e9)
        assert len(idx) == 0  # a NaN query: every distance is NaN, none kept
        idx, d = tt.batch_l2_squared_pruning(np.zeros(4, np.float32), tb, 1e9)
        assert 7 not in idx.tolist() and len(idx) == 299
        e = tt.batch_l2_squared_pruning(np.zeros(4, np.float32),
                                        tt.VerticalBatch(np.zeros((0, 4), np.float32)), 1.0)
        assert e[0].shape == (0,) and e[1].shape == (0,)
        with pytest.raises(ContractError):
            tt.batch_l2_squared_pruning(np.zeros(3, np.float32), tb, 1.0)

    @pytest.mark.parametrize("single", [False, True])
    def test_batch_knn_reordered(self, rng, single):
        rows = rng.standard_normal((N, 12)).astype(np.float32) * np.linspace(0.5, 3, 12,
                                                                             dtype=np.float32)
        qs = rng.standard_normal((3, 12)).astype(np.float32)
        q = qs[1] if single else qs
        got = tt.batch_knn_reordered(q, tt.VerticalBatch(rows), 5)
        want = it.batch_knn_reordered(q, it.VerticalBatch(rows), 5)
        tol = cond_tols(q, rows)["l2"]
        assert_topk_agrees(got.scores, got.indices, want.scores, want.indices,
                           tol[0] if single else tol)
        plain = tt.batch_knn(q, tt.VerticalBatch(rows), 5)
        np.testing.assert_array_equal(got.indices, plain.indices)

    @pytest.mark.parametrize("single", [False, True])
    def test_batch_knn_adaptive_exact_by_default(self, rng, single):
        rows = clustered(rng)
        qs = (rows[[50, 900]] + 0.01).astype(np.float32)
        q = qs[0] if single else qs
        jb, tb = batches(rows)
        got = tt.batch_knn_adaptive(q, tb, 5, 8)
        want = it.batch_knn_adaptive(q, jb, 5, 8)  # JAX: the exact pruned scan here
        exact = tt.batch_knn(q, tb, 5)
        np.testing.assert_array_equal(got.indices, exact.indices)
        np.testing.assert_array_equal(got.scores, exact.scores)
        np.testing.assert_array_equal(got.indices, want.indices)
        with pytest.raises(ContractError):
            tt.batch_knn_adaptive(q, tb, 5, 0)

    def test_small_corpus_is_exact_where_jax_is_approximate(self, rng):
        rows = rng.standard_normal((500, 16)).astype(np.float32)
        qs = rng.standard_normal((2, 16)).astype(np.float32)
        got = tt.batch_knn_adaptive(qs, tt.VerticalBatch(rows), 5, 4)
        exact = tt.batch_knn(qs, tt.VerticalBatch(rows), 5)
        np.testing.assert_array_equal(got.indices, exact.indices)

    @pytest.mark.parametrize("how", ["force_adaptive", "force_reference"])
    def test_warmup_path_matches_jax(self, rng, monkeypatch, how):
        rows = rng.standard_normal((600, 16)).astype(np.float32)
        qs = rng.standard_normal((3, 16)).astype(np.float32)
        if how == "force_adaptive":
            got = tt.batch_knn_adaptive(qs, tt.VerticalBatch(rows), 8, 4, force_adaptive=True)
            single = tt.batch_knn_adaptive(qs[0], tt.VerticalBatch(rows), 8, 4,
                                           force_adaptive=True)
        else:
            monkeypatch.setattr(tconfig, "_FORCE_REFERENCE", True)
            got = tt.batch_knn_adaptive(qs, tt.VerticalBatch(rows), 8, 4)
            single = tt.batch_knn_adaptive(qs[0], tt.VerticalBatch(rows), 8, 4)
        want = it.batch_knn_adaptive(qs, it.VerticalBatch.from_rows(rows), 8, 4,
                                     force_adaptive=True)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-5)
        kept = got.indices[0][got.indices[0] >= 0]
        np.testing.assert_array_equal(single.indices, kept)
        assert (got.indices == -1).any()  # the warmup prune really drops candidates


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestKernelsOnCuda:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("mode", ["dot", "l2", "dotm"])
    @pytest.mark.parametrize("tile_n", [128, 200])
    def test_tile_scan_matches_plain_exactly(self, cuda_device, dtype, mode, tile_n):
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        rows = torch.randint(-4, 5, (3077, 127), generator=gen, device=cuda_device).to(dtype)
        qs = torch.randint(-4, 5, (5, 127), generator=gen, device=cuda_device).float()
        n_tiles = -(-3077 // tile_n)
        alive = torch.rand(n_tiles, generator=gen, device=cuda_device) < 0.4
        order, n_surv = tp._survivor_order(alive, n_tiles)
        aux = {"dot": None, "l2": tk._norms2(rows),
               "dotm": (torch.rand(3077, generator=gen, device=cuda_device) < 0.5).float()}[mode]
        for k in (10, 259):  # 259: two exclusion-bounded passes
            before = tpk.LAUNCHES
            got = tpk.pruned_keys(qs, rows, aux, order, n_surv, tile_n, k, mode)
            assert tpk.LAUNCHES == before + (1 if k == 10 else 2)
            want = tpk.pruned_knn_plain(qs, rows, aux, order, n_surv, tile_n, k, mode)
            assert all(torch.equal(a, b) for a, b in zip(got, want))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_threshold_scan_matches_plain_exactly(self, cuda_device, dtype):
        gen = torch.Generator(device=cuda_device).manual_seed(6)
        rows = torch.randint(-4, 5, (3077, 128), generator=gen, device=cuda_device).to(dtype)
        q = torch.randint(-4, 5, (128,), generator=gen, device=cuda_device).float()
        alive = torch.rand(13, generator=gen, device=cuda_device) < 0.5
        order, n_surv = tp._survivor_order(alive, 13)
        before = tpk.THRESHOLD_LAUNCHES
        got = tpk.threshold_dists(q, rows, tk._norms2(rows), order, n_surv, 256)
        assert tpk.THRESHOLD_LAUNCHES == before + 1
        assert torch.equal(got, tpk.threshold_plain(q, rows, tk._norms2(rows), order, n_surv,
                                                    256))
