"""innr_tpu_torch.ops.fast_math against innr_tpu.ops.fast_math.

The bit-hack rsqrt is compared bit for bit over the float32 range (zeros,
negatives, infinities, NaN, every exponent down to 2**-120); ``fast_cosine``
within 1e-5 (hardware rsqrt on both sides). Below that, XLA on the CPU
flushes denormal operands and results to zero (0.5 x is denormal for x <
2**-125) and PyTorch does not, so there the port keeps IEEE arithmetic.
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


def wide_range(rng, n=20000):
    """float32 values over every exponent, both signs, and the specials."""
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    bits = np.where(np.abs(bits) < 2.0**-120, np.float32(1.0), bits)  # no denormal step
    special = np.array([0.0, -0.0, 1.0, 0.25, 4.0, 2.0**-120, 3.4e38, np.inf, -np.inf,
                        np.nan, -1.0, -1e-45], np.float32)
    return np.concatenate([bits, special])


class TestRsqrt:
    @pytest.mark.parametrize("fn", ["fast_rsqrt", "fast_rsqrt_precise"])
    def test_bits_equal_jax(self, rng, fn):
        x = wide_range(rng)
        got = getattr(itt, fn)(x)
        assert got.dtype == torch.float32
        want = np.asarray(getattr(it, fn)(x))
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))

    def test_denormal_inputs_are_not_flushed(self):
        """A positive denormal is > 0, so the bit hack runs on it (where
        XLA on the CPU reads it as 0 and returns 0)."""
        got = itt.fast_rsqrt(np.array([1e-45, 1e-39], np.float32)).numpy()
        assert (got > 0).all() and np.isfinite(got).all()

    def test_quarter(self):
        assert float(itt.fast_rsqrt(0.25)) == pytest.approx(2.0, rel=5e-3)

    def test_accuracy_contract(self, rng):
        x = np.abs(rng.standard_normal(5000)).astype(np.float32) + 1e-3
        exact = 1.0 / np.sqrt(x.astype(np.float64))
        rel1 = np.abs(itt.fast_rsqrt(x).numpy() - exact) / exact
        rel2 = np.abs(itt.fast_rsqrt_precise(x).numpy() - exact) / exact
        assert rel1.max() < 5e-3 and rel2.max() < 1e-5

    def test_nonpositive_and_nan_are_zero(self):
        got = itt.fast_rsqrt(np.array([0.0, -0.0, -4.0, -np.inf, np.nan], np.float32))
        assert got.tolist() == [0.0] * 5


class TestFastCosine:
    def test_against_jax(self, rng):
        for n in (1, 7, 128, 769):
            a = rng.standard_normal(n).astype(np.float32)
            b = rng.standard_normal(n).astype(np.float32)
            assert float(itt.fast_cosine(a, b)) == pytest.approx(float(it.fast_cosine(a, b)),
                                                                 abs=1e-5)
            assert float(itt.fast_cosine(a, b)) == pytest.approx(float(itt.cosine(a, b)),
                                                                 abs=1e-5)

    @pytest.mark.parametrize("n", [1, 3, 100])
    def test_mismatch_raises_regardless_of_size(self, n):
        with pytest.raises(itt.ContractError):
            itt.fast_cosine(np.ones(n), np.ones(n + 1))

    def test_small_norm_is_zero(self):
        tiny = np.full(4, 1e-12, np.float32)
        assert float(itt.fast_cosine(np.ones(4), tiny)) == 0.0
        assert float(itt.fast_cosine(np.zeros(4), np.zeros(4))) == 0.0

    def test_dispatch_alias(self, rng):
        a, b = rng.standard_normal(33), rng.standard_normal(33)
        assert torch.equal(itt.fast_cosine_dispatch(a, b), itt.fast_cosine(a, b))
