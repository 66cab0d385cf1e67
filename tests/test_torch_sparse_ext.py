"""innr_tpu_torch.ops.sparse_ext against innr_tpu.ops.sparse_ext.

The same numpy vectors go through both packages, as ``(indices, values)``
pairs and as ``[(dim, weight), ...]`` lists. Indices span the full 32 bits.
Integer-valued weights: results equal bit for bit; Gaussian: within
cond_tol.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from innr_tpu.ops import sparse_ext as jse  # noqa: E402
from conftest import cond_tol  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.ops import sparse_ext as tse  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch.utils.bits import unsigned_to_numpy  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def vec(rng, nnz, dim=2**32, integer=True, sort=True):
    idx = rng.choice(dim, nnz, replace=False).astype(np.uint32)
    if sort:
        idx = np.sort(idx)
    val = rng.integers(-4, 5, nnz) if integer else rng.standard_normal(nnz)
    return idx, val.astype(np.float32)


def as_list(v):
    return [(int(d), float(w)) for d, w in zip(*v)]


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


class TestAgainstJax:
    @pytest.mark.parametrize("form", ["pair", "list"])
    def test_sparse_dot(self, rng, form):
        a, b = vec(rng, 30, dim=200), vec(rng, 40, dim=200)
        if form == "list":
            a, b = as_list(a), as_list(b)
        assert bits(tse.sparse_dot(a, b)) == bits(jse.sparse_dot(a, b))

    def test_sparse_dot_full_width_indices(self, rng):
        a = vec(rng, 20)
        b = (np.concatenate([a[0][:10], [2**32 - 2]]).astype(np.uint32),
             np.arange(11, dtype=np.float32))
        b = (b[0][np.argsort(b[0])], b[1][np.argsort(b[0])])
        assert bits(tse.sparse_dot(a, b)) == bits(jse.sparse_dot(a, b))

    @pytest.mark.parametrize("sort", [True, False])
    def test_sparse_dense_dot_skips_out_of_bounds(self, rng, sort):
        dense = rng.integers(-3, 4, 100).astype(np.float32)
        v = vec(rng, 25, dim=300, sort=sort)
        got = tse.sparse_dense_dot(v, dense)
        assert bits(got) == bits(jse.sparse_dense_dot(v, dense))
        in_bounds = v[0] < 100
        assert float(got) == float(np.sum(v[1][in_bounds] * dense[v[0][in_bounds]]))
        # An entry >= 2**31 is out of bounds too (a signed view would index it).
        hi = (np.array([2**31 + 3, 5], np.uint32), np.array([7.0, 2.0], np.float32))
        assert float(tse.sparse_dense_dot(hi, dense)) == float(jse.sparse_dense_dot(hi, dense))
        assert float(tse.sparse_dense_dot(hi, [])) == 0.0

    def test_norm_and_normalize(self, rng):
        v = vec(rng, 16, integer=False)
        want = float(jse.sparse_l2_norm(v))
        assert float(tse.sparse_l2_norm(v)) == pytest.approx(want, abs=cond_tol(v[1], v[1]))
        ti, tv = tse.sparse_normalize(v)
        ji, jv = jse.sparse_normalize(v)
        np.testing.assert_array_equal(unsigned_to_numpy(ti), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=4e-7)
        z = (np.array([3], np.uint32), np.array([0.0], np.float32))
        assert tse.sparse_normalize(z)[1].tolist() == [0.0]

    @pytest.mark.parametrize("k", [0, 3, 16, 40])
    def test_top_k(self, rng, k):
        v = vec(rng, 16)  # integer weights: |w| ties, broken stably
        ti, tv = tse.sparse_top_k(v, k)
        ji, jv = jse.sparse_top_k(v, k)
        assert isinstance(ti, np.ndarray) and ti.dtype == np.uint32
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(tv, np.asarray(jv))

    def test_max_weight(self, rng):
        for v in (vec(rng, 12), (np.array([0, 1], np.uint32), np.array([-2.0, -1.0], np.float32)),
                  (np.zeros(0, np.uint32), np.zeros(0, np.float32))):
            assert bits(tse.sparse_max_weight(v)) == bits(jse.sparse_max_weight(v))
        nan = (np.array([1, 2], np.uint32), np.array([1.0, np.nan], np.float32))
        assert np.isnan(float(tse.sparse_max_weight(nan)))

    def test_length_mismatch_raises(self):
        with pytest.raises(ContractError, match="length mismatch"):
            tse.sparse_l2_norm((np.array([1, 2], np.uint32), np.array([1.0], np.float32)))
