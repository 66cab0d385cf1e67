"""innr_tpu_torch.utils.tensors.to_host: the one host copy of a top-k
result keeps the scores' bits (NaN payloads, -0.0) and widens the ids to
int64, for int32 and int64 ids, (Q, k), (Q, 0) and single-query shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from innr_tpu_torch.utils.tensors import to_host  # noqa: E402

# quiet NaN with a payload, negative NaN with a payload, -0.0, +0.0, -inf, 1.5
_BITS = np.array([0x7FC00001, -0x3FFEDD, -(2**31), 0, -0x800000, 0x3FC00000], np.int32)

HOST_CASES = {
    "payloads_and_signed_zero_int32_ids": (_BITS.reshape(2, 3), np.int32),
    "payloads_and_signed_zero_int64_ids": (_BITS.reshape(3, 2), np.int64),
    "no_columns": (np.zeros((4, 0), np.int32), np.int32),
    "no_columns_int64_ids": (np.zeros((2, 0), np.int32), np.int64),
    "single_query": (_BITS, np.int32),
    "single_query_int64_ids": (_BITS[:4], np.int64),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_to_host(case):
    bits, id_dtype = HOST_CASES[case]
    ids = np.arange(bits.size, dtype=id_dtype).reshape(bits.shape) * 7
    if id_dtype == np.int64:
        ids = ids + 2**33  # beyond int32: the pair is widened, not narrowed
    scores, got_ids = to_host(torch.from_numpy(bits.copy()).view(torch.float32),
                              torch.from_numpy(ids))
    assert scores.dtype == np.float32 and got_ids.dtype == np.int64
    assert scores.shape == got_ids.shape == bits.shape
    np.testing.assert_array_equal(scores.view(np.int32), bits)
    np.testing.assert_array_equal(got_ids, ids.astype(np.int64))
