"""innr_tpu_torch.utils.order against innr_tpu.utils.order: total-order keys
and top-k with NaN, +-inf, +-0 and ties. Integer keys: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from innr_tpu.utils import order as jo  # noqa: E402
from innr_tpu_torch.utils import order as to  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


SPECIALS = np.array(
    [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 1e-45, -1e-45,
     3.4e38, -3.4e38, 1.0, 0.0, np.nan],
    dtype=np.float32,
)


def specials_and_noise(rng, n=64):
    x = np.concatenate([SPECIALS, rng.standard_normal(n).astype(np.float32)])
    x[-8:] = x[:8]  # repeated values: ties at distant indices
    return x


def test_keys_match_jax(rng):
    x = specials_and_noise(rng)
    got = to.total_order_key_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jo.total_order_key_f32(jnp.asarray(x))))


def test_keys_invert_bit_exactly(rng):
    x = specials_and_noise(rng)
    back = to.invert_total_key(to.total_order_key_f32(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(back.view(np.int32), x.view(np.int32))


@pytest.mark.parametrize("descending", [False, True])
def test_argsort_matches_jax(rng, descending):
    x = specials_and_noise(rng)
    got = to.argsort_total(torch.from_numpy(x), descending=descending).numpy()
    want = np.asarray(jo.argsort_total(jnp.asarray(x), descending=descending))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [1, 5, 79])
def test_top_k_matches_jax(rng, largest, k):
    x = specials_and_noise(rng)[:79]
    gv, gi = to.top_k_total(torch.from_numpy(x), k, largest=largest)
    wv, wi = jo.top_k_total(jnp.asarray(x), k, largest=largest)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy().view(np.int32), np.asarray(wv).view(np.int32))


def test_top_k_batched_ties_go_low(rng):
    x = rng.integers(-2, 3, (4, 50)).astype(np.float32)
    gv, gi = to.top_k_total(torch.from_numpy(x), 9)
    wv, wi = jo.top_k_total(jnp.asarray(x), 9)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_composite_round_trip_and_empty_slot():
    keys = torch.tensor([-(2**31), -1, 0, 5, 2**31 - 1], dtype=torch.int32)
    idx = torch.tensor([0, 7, 2**31 - 1, 3, 1], dtype=torch.int32)
    k2, i2 = to.split_composite(to.composite_keys(keys, idx))
    assert torch.equal(k2, keys) and torch.equal(i2, idx)
    empty = torch.tensor([torch.iinfo(torch.int64).min])
    ek, ei = to.split_composite(empty)
    assert ek.item() == -(2**31) and ei.item() == -1
    # a real row always beats the empty slot, even with the lowest key
    assert to.composite_keys(keys[:1], torch.tensor([2**31 - 1])).item() > empty.item()


def test_composite_order_is_key_desc_then_index_asc():
    keys = torch.tensor([3, 3, 4, 3], dtype=torch.int32)
    comp = to.composite_keys(keys, torch.arange(4))
    assert torch.argsort(comp, descending=True).tolist() == [2, 0, 1, 3]
