"""The threshold scan's two forms (innr_tpu_torch.kernels.pruned_knn)
against innr_tpu.

- The compacted form, :func:`threshold_survivors` and
  ``batch_l2_squared_pruning`` on top of it, against JAX's
  ``batch_l2_squared_pruning`` (``innr_tpu/batch.py:495``) on the same
  numpy inputs: at N = 600 the JAX package takes its fused full pass, at
  N = 2100 (>= MIN_ROWS_PALLAS) its threshold kernel, in interpret mode.
- The dense form, :func:`threshold_dists`, against the JAX kernel's static
  twin ``_threshold_raw`` in interpret mode.

Tolerance: none. Rows, queries and centres are small integers (exact in
bf16), so every norm, dot and distance is an exact float32 value under any
summation order: indices and distances must be equal bit for bit, and a
threshold equal to a row's distance keeps that row in both packages.

The ``cuda``-marked tests hold the compacting kernel bit for bit against
the dense kernel followed by the keep-mask and ``nonzero``; they skip here
(``chip_smoke.py`` runs the same checks on the card).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
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


TILE = 256


def int_clustered(seed, n, d, nan_rows=()):
    """Rows of 6 integer centres in [-12, 12] plus noise in [-2, 2], sorted
    by centre so that tiles prune; NaN in ``nan_rows``. Returns the rows
    and an integer query next to row 100."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(-12, 13, (6, d))
    assign = np.sort(rng.integers(0, 6, n))
    rows = (centres[assign] + rng.integers(-2, 3, (n, d))).astype(np.float32)
    q = (rows[100] + rng.integers(-1, 2, d)).astype(np.float32)
    rows[list(nan_rows), 0] = np.nan
    return rows, q


def exact_l2(rows, q):
    with np.errstate(invalid="ignore"):
        return ((rows.astype(np.float64) - q) ** 2).sum(1)


def thresholds(l2):
    """Thresholds that keep nothing, the query's cluster, every row, and
    one equal to a row's distance (that row is kept)."""
    fin = np.sort(l2[np.isfinite(l2)])
    return {"none": float(fin[0]) - 1.0, "some": float(fin[len(fin) // 20]),
            "equal": float(fin[len(fin) // 40]), "every": float(fin[-1]), "inf": np.inf}


def batches(rows, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return (it.VerticalBatch(rows, dtype=jdt).set_prune_tile_n(TILE),
            tt.VerticalBatch(rows, dtype=tdt).set_prune_tile_n(TILE))


def assert_same(got, want):
    gi, gd = got
    wi, wd = (np.asarray(a) for a in want)
    assert gi.dtype == np.int64 and gd.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd.view(np.int32), wd.astype(np.float32).view(np.int32))


class TestCompactedAgainstJax:
    @pytest.mark.parametrize("kind", ["none", "some", "equal", "every", "inf"])
    @pytest.mark.parametrize("d", [1, 127, 128])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_batch_l2_squared_pruning(self, dtype, d, kind):
        rows, q = int_clustered(d, 600, d, nan_rows=(7, 301))
        l2 = exact_l2(rows, q)
        thr = thresholds(l2)[kind]
        jb, tb = batches(rows, dtype)
        got = tt.batch_l2_squared_pruning(q, tb, thr)
        assert_same(got, it.batch_l2_squared_pruning(q, jb, thr))
        want = np.nonzero(l2 <= thr)[0]  # NaN rows compare False
        np.testing.assert_array_equal(got[0], want)
        np.testing.assert_array_equal(got[1], l2[want].astype(np.float32))
        if kind == "equal":
            assert np.isin(np.nonzero(l2 == thr)[0], got[0]).all()
        if kind in ("every", "inf"):
            assert len(got[0]) == len(rows) - 2  # every row but the NaN rows

    @pytest.mark.parametrize("kind", ["some", "equal", "inf"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_against_the_jax_kernel_path(self, dtype, kind):
        """N >= MIN_ROWS_PALLAS: JAX runs its tile-skipping threshold
        kernel (interpret mode) on the same tiling."""
        rows, q = int_clustered(11, 2100, 128, nan_rows=(1500,))
        l2 = exact_l2(rows, q)
        thr = thresholds(l2)[kind]
        jb, tb = batches(rows, dtype)
        got = tt.batch_l2_squared_pruning(q, tb, thr)
        assert_same(got, it.batch_l2_squared_pruning(q, jb, thr))
        plan = tp.plan_threshold_survivors(torch.from_numpy(q[None]), tb.tile_summary().centroids,
                                           tb.tile_summary().radii, thr)
        if kind != "inf":
            assert int(plan[1]) < tb.tile_summary().n_tiles  # tiles were skipped

    def test_nan_query_keeps_nothing(self):
        rows, q = int_clustered(3, 600, 16)
        q[2] = np.nan
        jb, tb = batches(rows, "float32")
        got = tt.batch_l2_squared_pruning(q, tb, np.inf)
        assert len(got[0]) == 0
        assert_same(got, it.batch_l2_squared_pruning(q, jb, np.inf))


class TestCompactedPlain:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("plan", ["none", "one", "all", "scattered"])
    def test_equals_the_dense_form_masked(self, dtype, plan):
        """``threshold_survivors`` on the CPU is the dense form plus qq,
        masked and compacted, over the live tiles' rows: on any plan at a
        finite threshold, and on a plan of every tile (the planner's plan
        at +inf and NaN) at every threshold."""
        rows, q = int_clustered(5, 1000, 33)
        rows_t, q_t = torch.from_numpy(rows).to(dtype), torch.from_numpy(q)
        alive = {"none": np.zeros(4, bool), "one": np.eye(4, dtype=bool)[2],
                 "all": np.ones(4, bool), "scattered": np.array([1, 0, 1, 1], bool)}[plan]
        order, n_surv = tp._survivor_order(torch.from_numpy(alive), 4)
        norms2, qq = tk._norms2(rows_t), (q_t * q_t).sum()
        dense = tpk.threshold_dists(q_t, rows_t, norms2, order, n_surv, TILE) + qq
        for thr in (-1.0, 300.0, 1e4, np.inf, np.nan):
            idx, dists = tpk.threshold_survivors(q_t, rows_t, norms2, qq, order, n_surv, TILE,
                                                 thr)
            keep = ~(dense > float(np.float32(thr))) & ~torch.isnan(dense)
            live = torch.from_numpy(np.repeat(alive, TILE)[:1000])
            assert torch.equal(idx, torch.nonzero(keep & live).flatten())
            if np.isfinite(thr) or plan == "all":
                assert torch.equal(idx, torch.nonzero(keep).flatten())
            assert torch.equal(dists.view(torch.int32), dense[idx].view(torch.int32))
            assert bool((idx[1:] > idx[:-1]).all())

    def test_contracts(self):
        rows = torch.zeros((300, 4))
        q, order = torch.zeros(4), torch.arange(2, dtype=torch.int32)
        with pytest.raises(ContractError):
            tpk.threshold_survivors(q, rows.to(torch.int32), torch.zeros(300), q.sum(), order, 2,
                                    TILE, 1.0)
        with pytest.raises(ContractError):
            tpk.threshold_survivors(torch.zeros(5), rows, torch.zeros(300), q.sum(), order, 2,
                                    TILE, 1.0)
        with pytest.raises(ContractError):  # two tiles of 128 do not cover 300 rows
            tpk.threshold_survivors(q, rows, torch.zeros(300), q.sum(), order, 2, 128, 1.0)

    def test_the_dense_kernel_bitmap_must_fit_shared_memory(self):
        tpk._check_bitmap(768, 1_000_000, "threshold_dists")
        with pytest.raises(ContractError, match="shared memory"):
            tpk._check_bitmap(768, 8_000_000, "threshold_dists")


def emulated_plan(qd, qq, cc, rad, threshold, eps):
    """``csrc/pruned.cu:threshold_plan`` step by step in numpy float32 (one
    rounding an operation): ``(order, n_surv, alive)``."""
    f = np.float32
    with np.errstate(invalid="ignore"):
        a = qq[:, None] + cc[None, :]
        g = a - f(2) * qd
        g = np.where(np.isnan(g), g, np.maximum(g, f(0)))
        lower = np.sqrt(g) - rad[None, :]
        lower = np.where(np.isnan(lower), lower, np.maximum(lower, f(0)))
        slack = f(eps) * (a + f(2) * np.abs(qd))
        alive = (~(lower * lower > slack + f(threshold))).any(axis=0)
    live = np.nonzero(alive)[0].astype(np.int32)
    last = live[-1] if len(live) else 0
    order = np.full(alive.size, last, np.int32)
    order[:len(live)] = live
    return order, len(live), alive


class TestThresholdPlan:
    """The plan kernel's arithmetic and partition, emulated in numpy, against
    ``prune.plan_threshold_survivors`` (its plain version) on the CPU, with
    bounds near the threshold, NaN radii and centroids, Q = 1 and 3."""

    @pytest.mark.parametrize("n_q", [1, 3])
    @pytest.mark.parametrize("n_tiles", [1, 7, 1025, 3000])
    def test_emulation_equals_the_plain_plan(self, n_q, n_tiles):
        rng = np.random.default_rng(n_tiles + n_q)
        cent = rng.standard_normal((n_tiles, 24)).astype(np.float32)
        rad = np.abs(rng.standard_normal(n_tiles)).astype(np.float32)
        qs = rng.standard_normal((n_q, 24)).astype(np.float32)
        if n_tiles > 7:
            rad[5] = np.nan
            cent[9, 3] = np.nan
            cent[11] = qs[0]  # a centroid on the query: lower bound 0
        qt, ct, rt = (torch.from_numpy(a) for a in (qs, cent, rad))
        qd = (qt @ ct.T).numpy()
        qq = (qt * qt).sum(dim=1).numpy()
        cc = (ct * ct).sum(dim=1).numpy()
        with np.errstate(invalid="ignore"):
            exact = np.sqrt(np.maximum(qq[:, None] + cc[None, :] - 2 * qd, 0)) - rad
            lb = np.nanmedian(np.maximum(exact, 0) ** 2)
        for thr in (-np.inf, 0.0, float(lb), float(np.nextafter(np.float32(lb), 0)), 50.0,
                    np.inf, np.nan):
            order, n_surv, alive = tp.plan_threshold_survivors(qt, ct, rt, thr)
            want = emulated_plan(qd, qq, cc, rad, np.float32(thr), tconfig.PRUNE_BOUND_EPS)
            np.testing.assert_array_equal(alive.numpy(), want[2])
            assert int(n_surv) == want[1]
            np.testing.assert_array_equal(order.numpy(), want[0])
            got = tpk.threshold_plan(qt, ct, rt, thr)  # the plain version here
            assert all(torch.equal(a, b) for a, b in zip(got, (order, n_surv, alive)))


class TestDenseAgainstJax:
    @pytest.mark.parametrize("d", [1, 127, 128])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_static_twin_on_integer_rows(self, dtype, d):
        rows, q = int_clustered(20 + d, 2100, d)
        jr = jnp.asarray(rows.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else rows)
        tr = torch.from_numpy(rows).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        jn2, tn2 = jnp.sum(jr.astype(jnp.float32) ** 2, axis=1), tk._norms2(tr)
        alive = np.array([1, 0, 1, 1, 0, 0, 0, 1, 0], bool)
        order, n_surv = tp._survivor_order(torch.from_numpy(alive), alive.size)
        want = np.asarray(jpk._threshold_raw(jnp.asarray(q), jr, jn2, jnp.asarray(order.numpy()),
                                             jnp.asarray(int(n_surv), jnp.int32), TILE))[:2100]
        got = tpk.threshold_dists(torch.from_numpy(q), tr, tn2, order, n_surv, TILE).numpy()
        live = np.repeat(alive, TILE)[:2100]
        np.testing.assert_array_equal(got[live].view(np.int32), want[live].view(np.int32))
        assert np.isposinf(got[~live]).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestCompactOnCuda:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [1, 127, 128, 768])
    def test_compact_equals_dense_masked(self, cuda_device, dtype, d):
        gen = torch.Generator(device=cuda_device).manual_seed(d)
        n = 5000 + 77
        rows = torch.randn((n, d), generator=gen, device=cuda_device).to(dtype)
        rows[13, 0] = float("nan")
        q = torch.randn((d,), generator=gen, device=cuda_device)
        norms2, qq = tk._norms2(rows), (q * q).sum()
        n_tiles = -(-n // 200)
        alive = torch.rand(n_tiles, generator=gen, device=cuda_device) < 0.6
        alive[0] = True
        order, n_surv = tp._survivor_order(alive, n_tiles)
        before = dict(tpk.THRESHOLD_LAUNCHES_BY_FORM["compact"])
        dense = tpk.threshold_dists(q, rows, norms2, order, n_surv, 200) + qq
        for thr in (-1.0, float(dense[alive.repeat_interleave(200)[:n]].nanmedian()), 1e30):
            idx, dists = tpk.threshold_survivors(q, rows, norms2, qq, order, n_surv, 200, thr)
            keep = ~(dense > float(np.float32(thr))) & ~torch.isnan(dense)
            want = torch.nonzero(keep).flatten()
            assert torch.equal(idx, want.cpu())
            assert torch.equal(dists.view(torch.int32), dense[want].cpu().view(torch.int32))
        every = torch.arange(n_tiles, dtype=torch.int32, device=cuda_device)
        dense_all = tpk.threshold_dists(q, rows, norms2, every, n_tiles, 200) + qq
        idx, dists = tpk.threshold_survivors(q, rows, norms2, qq, every, n_tiles, 200, np.inf)
        assert len(idx) == n - 1  # every row but the NaN row
        assert torch.equal(dists.view(torch.int32), dense_all.cpu()[idx].view(torch.int32))
        key = str(dtype).removeprefix("torch.")
        assert tpk.THRESHOLD_LAUNCHES_BY_FORM["compact"][key] == before[key] + 4

    @pytest.mark.parametrize("n_q", [1, 3])
    @pytest.mark.parametrize("n_tiles", [1, 1024, 1025, 5000])
    def test_plan_kernel_equals_the_plain_plan(self, cuda_device, n_q, n_tiles):
        gen = torch.Generator(device=cuda_device).manual_seed(n_tiles + n_q)
        cent = torch.randn((n_tiles, 128), generator=gen, device=cuda_device)
        rad = torch.rand(n_tiles, generator=gen, device=cuda_device) * 12
        if n_tiles > 1:
            rad[n_tiles // 2] = float("nan")
        qs = torch.randn((n_q, 128), generator=gen, device=cuda_device)
        before = tpk.PLAN_LAUNCHES
        for thr in (-np.inf, 0.0, 100.0, 250.0, 400.0, np.inf, np.nan):
            got = tpk.threshold_plan(qs, cent, rad, thr)
            want = tp.plan_threshold_survivors(qs, cent, rad, thr)
            assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            assert int(got[1]) == int(want[1]) and got[1].dtype == torch.int32
        assert tpk.PLAN_LAUNCHES == before + 7

    def test_unordered_plan_raises(self, cuda_device):
        rows = torch.zeros((1024, 8), device=cuda_device)
        order = torch.tensor([3, 1, 0, 2], dtype=torch.int32, device=cuda_device)
        n_surv = torch.tensor([4], dtype=torch.int32, device=cuda_device)
        q = torch.zeros(8, device=cuda_device)
        with pytest.raises(ContractError, match="ascending"):
            tpk.threshold_survivors(q, rows, tk._norms2(rows), q.sum(), order, n_surv, 256, 1.0)

    def test_public_call_equals_its_plain_version(self, cuda_device):
        rows, q = int_clustered(9, 40_000, 128, nan_rows=(5,))
        vb = tt.VerticalBatch(torch.from_numpy(rows).to(cuda_device)).set_prune_tile_n(512)
        got = tt.batch_l2_squared_pruning(q, vb, 400.0)
        cpu = tt.batch_l2_squared_pruning(q, tt.VerticalBatch(rows).set_prune_tile_n(512), 400.0)
        np.testing.assert_array_equal(got[0], cpu[0])
        np.testing.assert_array_equal(got[1].view(np.int32), cpu[1].view(np.int32))
