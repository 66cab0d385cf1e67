"""innr_tpu_torch.kernels.assign against innr_tpu.kernels.assign.

The same numpy rows and centroids go through the JAX nearest-centroid
kernel (interpret mode on the CPU, as innr_tpu's own tests run it; XLA's
matmul + argmin above 4 x 2048 centroids) and the port's plain version.

Tolerances:
- integer-valued rows and centroids: every score is exact in both, so the
  assignments are equal, ties included (lowest centroid);
- Gaussian rows: equal wherever the best score beats the second best by
  more than cond_tol of the score (32 eps (||c||^2 + 2 sum|x_i c_i|)).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from innr_tpu.kernels import assign as ja  # noqa: E402
from innr_tpu_torch.kernels import assign as ta  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


EPS = float(np.finfo(np.float32).eps)


def both(rows, cent, dtype="float32"):
    if dtype == "bfloat16":
        jr = jnp.asarray(rows.astype(ml_dtypes.bfloat16))
        tr = torch.from_numpy(rows).to(torch.bfloat16)
    else:
        jr, tr = jnp.asarray(rows), torch.from_numpy(rows)
    want = np.asarray(ja.nearest_centroid(jr, jnp.asarray(cent)))
    got = ta.nearest_centroid(tr, torch.from_numpy(cent))
    assert got.dtype == torch.int32
    return got.numpy(), want


class TestAgainstJax:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,d,kc", [(300, 8, 1), (1000, 16, 7), (513, 32, 256),
                                        (129, 7, 2100)])
    def test_integer_rows_exact(self, rng, n, d, kc, dtype):
        rows = rng.integers(-4, 5, (n, d)).astype(np.float32)
        cent = rng.integers(-4, 5, (kc, d)).astype(np.float32)
        got, want = both(rows, cent, dtype)
        np.testing.assert_array_equal(got, want)

    def test_exact_ties_pick_lowest_centroid(self, rng):
        base = rng.integers(-3, 4, (5, 16)).astype(np.float32)
        cent = np.concatenate([base, base[::-1], base])  # every centroid 3 times
        rows = base[rng.integers(0, 5, 200)] + rng.integers(-1, 2, (200, 16)).astype(np.float32)
        got, want = both(rows, cent)
        np.testing.assert_array_equal(got, want)
        assert got.max() < 5

    def test_many_centroids_past_the_jax_kernel_gate(self, rng):
        """KC > 4 x 2048: JAX hands the pass to XLA's matmul + argmin, the
        port keeps one rule for every KC."""
        rows = rng.integers(-2, 3, (64, 4)).astype(np.float32)
        cent = rng.integers(-2, 3, (8300, 4)).astype(np.float32)
        got, want = both(rows, cent)
        np.testing.assert_array_equal(got, want)

    def test_gaussian_rows_where_the_margin_is_clear(self, rng):
        cent = (3 * rng.standard_normal((40, 24))).astype(np.float32)
        rows = (cent[rng.integers(0, 40, 800)]
                + 0.5 * rng.standard_normal((800, 24))).astype(np.float32)
        got, want = both(rows, cent)
        x, c = rows.astype(np.float64), cent.astype(np.float64)
        score = (c * c).sum(1)[None, :] - 2 * x @ c.T
        tol = 32 * EPS * ((c * c).sum(1)[None, :] + 2 * np.abs(x) @ np.abs(c).T)
        best2 = np.sort(score, axis=1)[:, :2]
        clear = best2[:, 1] - best2[:, 0] > 2 * tol.max(axis=1)
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got[clear], want[clear])

    def test_nan_row_gets_zero(self, rng):
        rows = rng.integers(-4, 5, (50, 8)).astype(np.float32)
        rows[[3, 20]] = np.nan
        cent = rng.integers(-4, 5, (6, 8)).astype(np.float32)
        got, want = both(rows, cent)
        assert got[3] == got[20] == 0
        np.testing.assert_array_equal(got, want)

    def test_all_negative_scores(self):
        cent = np.full((3, 4), 10.0, np.float32)
        cent[1] = 20.0
        rows = np.full((5, 4), -1.0, np.float32)
        got, want = both(rows, cent)
        np.testing.assert_array_equal(got, want)

    def test_uint8_rows_widen(self, rng):
        codes = rng.integers(0, 256, (300, 12)).astype(np.uint8)
        cent = rng.integers(0, 256, (9, 12)).astype(np.float32)
        want = np.asarray(ja.nearest_centroid(jnp.asarray(codes), jnp.asarray(cent)))
        got = ta.nearest_centroid(torch.from_numpy(codes), torch.from_numpy(cent)).numpy()
        np.testing.assert_array_equal(got, want)


class TestPlainVersion:
    def test_chunks_agree_with_one_block(self, rng, monkeypatch):
        rows = torch.from_numpy(rng.integers(-4, 5, (333, 6)).astype(np.float32))
        cent = torch.from_numpy(rng.integers(-4, 5, (17, 6)).astype(np.float32))
        one = ta.nearest_centroid_plain(rows, cent)
        monkeypatch.setattr(ta, "_PLAIN_CHUNK", 17 * 5)  # 5 rows a chunk
        assert torch.equal(ta.nearest_centroid_plain(rows, cent), one)

    def test_empty_rows(self):
        out = ta.nearest_centroid(torch.zeros((0, 3)), torch.ones((2, 3)))
        assert out.shape == (0,) and out.dtype == torch.int32

    @pytest.mark.parametrize("rows,cent", [
        (torch.ones(4, 3, dtype=torch.float64), torch.ones(2, 3)),
        (torch.ones(4, 3), torch.ones(2, 4)),
        (torch.ones(4, 3), torch.ones(0, 3)),
        (torch.ones(3), torch.ones(2, 3)),
    ])
    def test_contracts(self, rows, cent):
        with pytest.raises(ContractError):
            ta.nearest_centroid(rows, cent)

    def test_meta_device_raises(self):
        with pytest.raises(ContractError, match="unsupported device"):
            ta.nearest_centroid(torch.ones(4, 3, device="meta"), torch.ones(2, 3, device="meta"))


def _tf32(a):
    """float32 values as the tensor core reads them: the low 13 mantissa
    bits dropped (truncation)."""
    return (np.ascontiguousarray(a, np.float32).view(np.int32) & ~0x1FFF).view(np.float32)


def _shortlist(rows, cent):
    """The kernel's shortlist, emulated: TF32 dots in float64, each pushed
    by the tensor core's worst accumulation error, the winner's up and every
    other centroid's down, so the bound must absorb it. Returns the (N, KC)
    admitted mask and the plain version's winners."""
    x = rows.astype(np.float32)
    c = cent.astype(np.float32)
    d = x.shape[1]
    winner = ta.nearest_centroid_plain(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    xt, ct = _tf32(x).astype(np.float64), _tf32(c).astype(np.float64)
    dot = xt @ ct.T
    acc_err = 2 * (d + 8) * 2.0**-23 * (np.abs(xt) @ np.abs(ct).T)
    cn = ta._cent_norms2(torch.from_numpy(c)).numpy().astype(np.float64)
    s = cn[None, :] - 2 * dot
    push = np.where(np.arange(c.shape[0])[None, :] == winner[:, None], 2.0, -2.0)
    s = s + push * acc_err
    m = ta.shortlist_margin(d)
    xn = np.sqrt((x * x).sum(1, dtype=np.float32)).astype(np.float64)
    cnorm = np.sqrt(cn)
    t = (m.kappa * xn[:, None] * cnorm[None, :] + m.tau * np.abs(cn)[None, :]
         + m.abs_norm * cnorm[None, :] + m.abs_const)
    thr = (s + t).min(axis=1, keepdims=True)
    return s - t <= thr, winner


class TestShortlistMargin:
    """The margin the kernel's shortlist uses holds the exact winner on
    near ties: duplicated centroids, centroids one ulp apart, rows between
    two centroids, f32 rows that TF32 rounds."""

    @pytest.mark.parametrize("d", [1, 7, 128, 130, 300])
    @pytest.mark.parametrize("trial", range(3))
    def test_winner_inside_the_shortlist(self, rng, d, trial):
        base = rng.standard_normal((24, d)).astype(np.float32) * rng.choice([0.01, 1.0, 300.0])
        ulp = np.nextafter(base[:6], np.float32(np.inf))  # every coordinate 1 ulp up
        one = base[6:12].copy()
        one[:, 0] = np.nextafter(one[:, 0], np.float32(-np.inf))
        cent = np.concatenate([base, base[:6], ulp, one])  # exact duplicates too
        pair = rng.integers(0, len(base), (400, 2))
        w = rng.random((400, 1)).astype(np.float32)
        rows = (w * base[pair[:, 0]] + (1 - w) * base[pair[:, 1]])
        rows[:100] = (base[pair[:100, 0]] + base[pair[:100, 1]]) / 2  # equidistant
        rows[100:150] = cent[rng.integers(0, len(cent), 50)]  # on a centroid
        rows = (rows + 1e-4 * rng.standard_normal(rows.shape)).astype(np.float32)
        admitted, winner = _shortlist(rows, cent)
        assert admitted[np.arange(len(rows)), winner].all()

    def test_integer_rows_and_the_smoke_near_ties(self, rng):
        """u8 / bf16-like integer rows, centroids on a 2^-12 grid 1-2 units
        apart: exact dots, inexact TF32 centroids."""
        d = 130
        rows = rng.integers(-3, 4, (500, d)).astype(np.float32)
        grid = rng.integers(-4 * 4096 + 1, 4 * 4096, (40, d)).astype(np.float64)
        cent = np.concatenate([grid, grid + 1, grid - 2]) / 4096.0
        admitted, winner = _shortlist(rows, cent.astype(np.float32))
        assert admitted[np.arange(len(rows)), winner].all()

    def test_clear_winners_give_short_lists(self, rng):
        cent = (3 * rng.standard_normal((64, 128))).astype(np.float32)
        rows = (cent[rng.integers(0, 64, 2000)]
                + 0.3 * rng.standard_normal((2000, 128))).astype(np.float32)
        admitted, winner = _shortlist(rows, cent)
        assert admitted[np.arange(2000), winner].all()
        assert admitted.sum(1).mean() < 1.1

    def test_margin_grows_with_d_and_stays_small(self):
        small, big = ta.shortlist_margin(8), ta.shortlist_margin(4096)
        assert 2 * 2 * 2.0**-10 < small.kappa < big.kappa < 0.02
        assert small.tau == big.tau and small.abs_const < big.abs_const < 1e-18


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestKernelOnCuda:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
    @pytest.mark.parametrize("d,kc", [(7, 3), (128, 256), (300, 2049)])
    def test_kernel_matches_plain_exactly(self, cuda_device, dtype, d, kc):
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        if dtype == torch.uint8:
            rows = torch.randint(0, 256, (3077, d), generator=gen, device=cuda_device,
                                 dtype=torch.uint8)
        else:
            rows = torch.randint(-4, 5, (3077, d), generator=gen, device=cuda_device).to(dtype)
        cent = torch.randint(-4, 5, (kc, d), generator=gen, device=cuda_device).float()
        before = ta.LAUNCHES
        got = ta.nearest_centroid(rows, cent)
        assert ta.LAUNCHES == before + 1
        assert torch.equal(got, ta.nearest_centroid_plain(rows, cent))
