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


_I32_MIN = -(2**31)
# split_composite of the empty slot, torch.iinfo(torch.int64).min
_EMPTY_PAIR = (_I32_MIN, -1)


def _pair(rows):
    """One part from per-query lists of (key, id)."""
    return (torch.tensor([[c[0] for c in r] for r in rows], dtype=torch.int32),
            torch.tensor([[c[1] for c in r] for r in rows], dtype=torch.int32))


MERGE_CASES = {
    "ties_across_parts_go_to_the_lowest_id": (
        [[[(5, 9), (5, 4), (2, 1)], [(7, 3), (1, 0), (0, 2)]],
         [[(5, 2), (3, 8), (2, 10)], [(7, 1), (7, 6), (0, 5)]],
         [[(5, 6), (5, 0), (2, 7)], [(1, 4), (0, 9), (0, 7)]]], 5),
    "parts_hold_fewer_than_k": (
        [[[(4, 0)], [(-3, 1)]],
         [[(9, 5), (4, 3)], [(_I32_MIN + 1, 2), (-3, 0)]],
         [[(4, 2), (-7, 6)], [(8, 4), (-3, 9)]]], 4),
    "a_single_full_part": ([[[(9, 3), (4, 1), (4, 2)], [(2, 0), (1, 5), (-1, 4)]]], 3),
    "empty_slots_never_win": (
        [[[(_I32_MIN + 1, 7), _EMPTY_PAIR, _EMPTY_PAIR], [(0, 1), _EMPTY_PAIR, _EMPTY_PAIR]],
         [[(3, 2), (_I32_MIN + 1, 0), _EMPTY_PAIR], [(0, 0), (-5, 4), _EMPTY_PAIR]],
         [[_EMPTY_PAIR, _EMPTY_PAIR, _EMPTY_PAIR], [_EMPTY_PAIR, _EMPTY_PAIR, _EMPTY_PAIR]]], 3),
    "empty_slots_fill_only_the_tail": (
        [[[(6, 1), _EMPTY_PAIR], [(2, 0), _EMPTY_PAIR]],
         [[(6, 0), _EMPTY_PAIR], [_EMPTY_PAIR, _EMPTY_PAIR]]], 3),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_parts(case):
    """The one candidate merge: the k best by key descending, then the
    lowest id, against a plain sort of every candidate; the split of an
    empty slot sorts below every key above INT32_MIN."""
    parts, k = MERGE_CASES[case]
    pairs = [_pair(p) for p in parts]
    keys, ids = to.merge_parts(pairs, k, torch.device("cpu"))
    assert keys.dtype == ids.dtype == torch.int32 and tuple(keys.shape) == (len(parts[0]), k)
    for q in range(len(parts[0])):
        cands = [c for p in parts for c in p[q]]
        want = sorted(cands, key=lambda c: (-c[0], c[1]))[:k]
        assert list(zip(keys[q].tolist(), ids[q].tolist())) == want
    if len(pairs) == 1:  # a full part passes as it is
        assert keys is pairs[0][0] and ids is pairs[0][1]
