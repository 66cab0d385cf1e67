"""innr_tpu_torch.ops.quant against innr_tpu.ops.quant.

Every result is an integer: equal values (the JAX package returns uint32,
the port int64 dots and int32 counts). The popcount helpers are held
against Python's own bit count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import innr_tpu.ops.quant as jq  # noqa: E402
import innr_tpu_torch.ops.quant as tq  # noqa: E402
from innr_tpu_torch.utils import bits  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def test_popcount32_over_all_bits(rng):
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.array([bin(int(v)).count("1") for v in x])
    got = bits.popcount32(bits.words_from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_popcount8(rng):
    x = np.arange(256, dtype=np.uint8)
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(bits.popcount8(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("d", [1, 31, 32, 33, 77])
def test_pack_unpack_round_trip_and_sign_bit(rng, d):
    b = rng.random((6, d)) < 0.5
    b[0] = True  # bit 31 of every full word lands in the sign bit
    words = bits.pack_bits(torch.from_numpy(b))
    assert words.shape == (6, bits.num_words(d))
    np.testing.assert_array_equal(bits.unpack_bits(words, d).numpy(), b.astype(np.int32))
    if d >= 32:
        assert int(words[0, 0]) == -1  # all 32 bits set


@pytest.mark.parametrize("d", [1, 16, 257])
def test_dot_u8_and_hamming_distance(rng, d):
    a = rng.integers(0, 256, d).astype(np.uint8)
    b = rng.integers(0, 256, d).astype(np.uint8)
    assert int(tq.dot_u8(a, b)) == int(jq.dot_u8(a, b))
    assert int(tq.hamming_distance(a, b)) == int(jq.hamming_distance(a, b))


def test_dot_u8_past_int32_is_exact():
    """255**2 * 40000 > 2**31: int64 holds it (the JAX uint32 still fits)."""
    a = np.full(40000, 255, np.uint8)
    assert int(tq.dot_u8(a, a)) == 255 * 255 * 40000 == int(jq.dot_u8(a, a))
    assert int(tq.batch_dot_u8(a, a[None, :])[0]) == 255 * 255 * 40000


@pytest.mark.parametrize("n,w", [(1, 1), (300, 7), (64, 96)])
def test_batch_forms(rng, n, w):
    q = rng.integers(0, 256, w).astype(np.uint8)
    c = rng.integers(0, 256, (n, w)).astype(np.uint8)
    c[0] = q
    ham = tq.batch_hamming(q, c)
    assert ham.dtype == torch.int32 and int(ham[0]) == 0
    np.testing.assert_array_equal(ham.numpy(), np.asarray(jq.batch_hamming(q, c)))
    want = np.asarray(jq.batch_dot_u8(jnp.asarray(q), jnp.asarray(c)))
    np.testing.assert_array_equal(tq.batch_dot_u8(q, c).numpy(), want)
    np.testing.assert_array_equal(tq.batch_dot_u8_s8(q, c).numpy(), want)
    np.testing.assert_array_equal(
        tq.batch_dot_u8_s8(q, c).numpy(), np.asarray(jq.batch_dot_u8_s8(q, c)))


def test_empty_inputs_are_zero():
    e = np.zeros(0, np.uint8)
    assert int(tq.dot_u8(e, e)) == 0 and int(tq.hamming_distance(e, e)) == 0


@pytest.mark.parametrize("fn", ["dot_u8", "hamming_distance", "batch_hamming",
                                "batch_dot_u8", "batch_dot_u8_s8"])
def test_length_mismatch_raises(fn):
    a = np.zeros(4, np.uint8)
    b = np.zeros((3, 5), np.uint8) if fn.startswith("batch") else np.zeros(5, np.uint8)
    with pytest.raises(ContractError, match=fn):
        getattr(tq, fn)(a, b)
