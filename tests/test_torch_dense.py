"""innr_tpu_torch.ops.dense against innr_tpu.ops.dense.

The same numpy vectors go through both packages: exact values, the crate's
contracts (length mismatch raises, empty -> 0.0, zero and NaN norms give a
cosine of 0.0, NaN propagates through dot and the distances), and
differential checks over the reference's boundary dimensions within
cond_tol (32 eps of the sum of |products|: the two packages sum in
different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from conftest import BOUNDARY_DIMS, cond_tol  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


PAIR_FNS = ["dot", "cosine", "l1_distance", "l2_distance", "l2_distance_squared",
            "angular_distance"]


def vec(rng, n, scale=1.0):
    return (rng.standard_normal(n) * scale).astype(np.float32)


class TestExactValues:
    @pytest.mark.parametrize("fn,a,b,want", [
        ("dot", [1.0, 2.0, 3.0], [4.0, 5.0, 6.0], 32.0),
        ("cosine", [1.0, 0.0], [0.0, 1.0], 0.0),
        ("cosine", [1.0, 0.0], [2.0, 0.0], 1.0),
        ("l2_distance", [0.0, 0.0], [3.0, 4.0], 5.0),
        ("l2_distance_squared", [0.0, 0.0], [3.0, 4.0], 25.0),
        ("l1_distance", [1.0, 2.0], [4.0, 0.0], 5.0),
        ("angular_distance", [1.0, 0.0], [0.0, 1.0], 0.5),
    ])
    def test_pair(self, fn, a, b, want):
        got = getattr(itt, fn)(a, b)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, abs=1e-6)
        assert float(got) == pytest.approx(float(getattr(it, fn)(a, b)), abs=1e-6)

    def test_norm_and_normalize(self):
        assert float(itt.norm([3.0, 4.0])) == 5.0
        np.testing.assert_allclose(itt.normalize([3.0, 4.0]).numpy(),
                                   np.asarray(it.normalize([3.0, 4.0])), rtol=1e-6)
        out, n = itt.normalize_with_norm([3.0, 4.0])
        assert float(n) == 5.0 and float(itt.norm(out)) == pytest.approx(1.0, rel=1e-6)


class TestContracts:
    @pytest.mark.parametrize("fn", [f for f in PAIR_FNS])
    def test_length_mismatch_raises(self, fn):
        with pytest.raises(itt.ContractError, match=r"innr_tpu_torch::\w+: length mismatch"):
            getattr(itt, fn)([1.0, 2.0], [1.0, 2.0, 3.0])
        with pytest.raises(it.ContractError):
            getattr(it, fn)([1.0, 2.0], [1.0, 2.0, 3.0])

    def test_empty_inputs_zero(self):
        z = np.zeros((0,), np.float32)
        for fn in ("dot", "cosine", "l1_distance", "l2_distance_squared"):
            assert float(getattr(itt, fn)(z, z)) == 0.0
        assert float(itt.norm(z)) == 0.0

    @pytest.mark.parametrize("other", [np.zeros(4), np.full(4, 1e-12), [1.0, np.nan, 0.0, 0.0]])
    def test_zero_tiny_or_nan_norm_cosine_is_zero(self, other):
        a = np.ones(4, np.float32)
        b = np.asarray(other, np.float32)
        assert float(itt.cosine(a, b)) == 0.0 == float(it.cosine(a, b))
        assert float(itt.cosine(b, b)) == 0.0

    def test_nan_propagates_through_dot_and_distances(self):
        a = np.array([1.0, np.nan], np.float32)
        b = np.array([1.0, 1.0], np.float32)
        for fn in ("dot", "l2_distance", "l2_distance_squared", "l1_distance"):
            assert np.isnan(float(getattr(itt, fn)(a, b)))

    def test_normalize_zero_and_tiny_vectors_unchanged(self):
        for v in (np.zeros(3, np.float32), np.full(3, 1e-12, np.float32)):
            out, n = itt.normalize_with_norm(v)
            np.testing.assert_array_equal(out.numpy(), v)
            assert float(n) == pytest.approx(float(np.linalg.norm(v)))

    def test_tensor_keeps_its_device_and_second_follows(self):
        a = torch.tensor([1.0, 2.0], dtype=torch.float64)
        got = itt.dot(a, np.array([3.0, 4.0]))
        assert got.dtype == torch.float32 and got.device == a.device and float(got) == 11.0


class TestDifferential:
    @pytest.mark.parametrize("dim", BOUNDARY_DIMS)
    def test_pair_ops_against_jax(self, rng, dim):
        a, b = vec(rng, dim), vec(rng, dim)
        for fn in ("dot", "l2_distance_squared"):
            tol = cond_tol(a - b, a - b) if fn.startswith("l2") else cond_tol(a, b)
            assert float(getattr(itt, fn)(a, b)) == pytest.approx(
                float(getattr(it, fn)(a, b)), abs=tol)
        assert float(itt.l1_distance(a, b)) == pytest.approx(
            float(it.l1_distance(a, b)), abs=cond_tol(np.abs(a - b), np.ones(dim)))
        assert float(itt.cosine(a, b)) == pytest.approx(float(it.cosine(a, b)), abs=1e-5)
        assert float(itt.angular_distance(a, b)) == pytest.approx(
            float(it.angular_distance(a, b)), abs=1e-5)

    def test_mixed_magnitudes(self, rng):
        a = vec(rng, 300) * np.float32(10.0) ** rng.integers(-6, 6, 300).astype(np.float32)
        b = vec(rng, 300)
        assert float(itt.dot(a, b)) == pytest.approx(float(it.dot(a, b)), abs=cond_tol(a, b))


class TestMatryoshka:
    @pytest.mark.parametrize("prefix", [0, 1, 16, 64, 200])
    def test_against_jax(self, rng, prefix):
        a, b = vec(rng, 64), vec(rng, 48)
        assert float(itt.matryoshka_dot(a, b, prefix)) == pytest.approx(
            float(it.matryoshka_dot(a, b, prefix)), abs=cond_tol(a[:prefix], b[:prefix]))
        assert float(itt.matryoshka_cosine(a, b, prefix)) == pytest.approx(
            float(it.matryoshka_cosine(a, b, prefix)), abs=1e-5)

    def test_prefix_equals_sliced_and_clamps(self, rng):
        a, b = vec(rng, 32), vec(rng, 32)
        assert torch.equal(itt.matryoshka_dot(a, b, 8), itt.dot(a[:8], b[:8]))
        assert torch.equal(itt.matryoshka_cosine(a, b, 99), itt.cosine(a, b))
