"""innr_tpu_torch.ops.dense_f64 (native float64) against innr_tpu.ops.dense_f64.

The JAX package computes in double-f32 pairs (about 2**-48 relative) with
x64 off, as here; the port in native float64. Both are held to a float64
numpy oracle: the port within 1e-13 relative (summation order only), the
JAX package within its own 1e-9 contract, and to each other within the
JAX package's error.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def oracle(name, a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = min(a.size, b.size)
    a, b = a[:n], b[:n]
    return {"dot_f64": float(a @ b), "l2_distance_squared_f64": float((a - b) @ (a - b)),
            "l1_distance_f64": float(np.abs(a - b).sum())}[name]


class TestAgainstJaxAndOracle:
    @pytest.mark.parametrize("name", ["dot_f64", "l2_distance_squared_f64", "l1_distance_f64"])
    @pytest.mark.parametrize("dim", [1, 7, 33, 128, 1535])
    def test_reductions(self, rng, name, dim):
        a, b = rng.standard_normal(dim), rng.standard_normal(dim)
        got = getattr(itt, name)(a, b)
        want = oracle(name, a, b)
        scale = oracle("dot_f64", np.abs(a), np.abs(b)) + oracle("l1_distance_f64", a, b) ** 2
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-13, abs=1e-13 * scale)
        assert got == pytest.approx(getattr(it, name)(a, b), rel=1e-9, abs=1e-9 * scale)

    def test_cancellation_f32_would_lose(self):
        a = np.array([1e8, 1.0, -1e8], np.float64)
        b = np.ones(3, np.float64)
        assert itt.dot_f64(a, b) == 1.0 == it.dot_f64(a, b)

    def test_norm_normalize_cosine(self, rng):
        v = rng.standard_normal(50)
        assert itt.norm_f64(v) == pytest.approx(float(np.linalg.norm(v)), rel=1e-14)
        out, n = itt.normalize_f64(v)
        assert out.dtype == torch.float64 and n == pytest.approx(it.norm_f64(v), rel=1e-9)
        np.testing.assert_allclose(out.numpy(), it.normalize_f64(v)[0], rtol=1e-9)
        w = rng.standard_normal(50)
        assert itt.cosine_f64(v, w) == pytest.approx(it.cosine_f64(v, w), rel=1e-9)
        assert itt.l2_distance_f64([0.0, 0.0], [3.0, 4.0]) == 5.0


class TestContracts:
    def test_min_length_no_raise(self, rng):
        a, b = rng.standard_normal(10), rng.standard_normal(7)
        assert itt.dot_f64(a, b) == pytest.approx(float(a[:7] @ b), rel=1e-14)
        assert itt.l1_distance_f64(a, b) == pytest.approx(it.l1_distance_f64(a, b), rel=1e-9)

    def test_empty_zero(self):
        for fn in ("dot_f64", "l2_distance_squared_f64", "l1_distance_f64", "cosine_f64"):
            assert getattr(itt, fn)([], [1.0, 2.0]) == 0.0

    def test_zero_norm_guard_and_unchanged_normalize(self):
        assert itt.cosine_f64([0.0, 0.0], [1.0, 2.0]) == 0.0
        out, n = itt.normalize_f64([1e-17, 0.0])
        assert n < 2.3e-16 and out.tolist() == [1e-17, 0.0]

    @pytest.mark.parametrize("impl", ["auto", "native", "df64"])
    def test_impl_values_run_native_float64(self, rng, impl):
        a, b = rng.standard_normal(20), rng.standard_normal(20)
        assert itt.dot_f64(a, b, impl=impl) == itt.dot_f64(a, b)

    def test_unknown_impl_raises(self):
        for fn in ("dot_f64", "l2_distance_squared_f64", "l1_distance_f64", "norm_f64"):
            args = ([1.0],) if fn == "norm_f64" else ([1.0], [2.0])
            with pytest.raises(ValueError, match="unknown dense_f64 impl"):
                getattr(itt, fn)(*args, impl="fast")
