"""innr_tpu_torch.ops.binary against innr_tpu.ops.binary.

The same numpy inputs build both packages' state (the port's int32 words
are the JAX package's uint32 words, bit for bit). The kNN functions run at
N = 2100 >= MIN_ROWS_PALLAS, so the JAX package takes its Pallas kernel
(interpret mode on the CPU) and the port its kernel's plain version. Every
result is an integer: equal counts and indices; Jaccard is one float32
division of equal integers, so it is equal too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.ops import binary as tb  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch.utils.bits import words_to_numpy  # noqa: E402
from test_torch_packed_knn import N, words  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def u32(t):
    return words_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t, np.uint32)


def corpus(rng, d, n=N):
    """Random words over all 32 bits; rows 50 and 900 copy row 7."""
    w = words(rng, (n, -(-d // 32)))
    w[[50, 900]] = w[7]
    return w


@pytest.mark.parametrize("d", [1, 31, 32, 33, 77, 96])
def test_encode_matches_jax(rng, d):
    rows = rng.standard_normal((40, d)).astype(np.float32)
    rows[0, 0] = np.nan  # NaN -> 0
    rows[1, :] = 0.25    # equal to the threshold -> 0 (strictly greater)
    np.testing.assert_array_equal(
        u32(itt.encode_binary_batch(rows, 0.25)), np.asarray(it.encode_binary_batch(rows, 0.25)))
    np.testing.assert_array_equal(
        u32(itt.encode_binary(rows[2]).words), np.asarray(it.encode_binary(rows[2]).words))
    tb_batch = itt.PackedBinaryBatch.encode(rows)
    jb_batch = it.PackedBinaryBatch.encode(rows)
    np.testing.assert_array_equal(u32(tb_batch.words), np.asarray(jb_batch.words))
    np.testing.assert_array_equal(u32(tb_batch.words_t), np.asarray(jb_batch.words_t))
    assert tb_batch.memory_bytes() == jb_batch.memory_bytes()
    assert (tb_batch.num_vectors, tb_batch.dimension) == (40, d)


@pytest.mark.parametrize("d", [5, 32, 77])
def test_packed_binary_state(rng, d):
    raw = words(rng, -(-d // 32))  # padding bits set: both constructors clear them
    j, t = it.PackedBinary(raw, d), itt.PackedBinary.from_numpy(raw, d)
    np.testing.assert_array_equal(u32(t.words), np.asarray(j.words))
    assert t.count_ones() == j.count_ones()
    assert t.memory_bytes() == j.memory_bytes()
    np.testing.assert_array_equal(t.data_u64(), j.data_u64())
    assert itt.PackedBinary.from_u64(j.data_u64(), d) == t
    assert [t.get(i) for i in range(-1, d + 1)] == [j.get(i) for i in range(-1, d + 1)]
    for idx, val in ((0, True), (d - 1, False), (d - 1, True), (min(31, d - 1), True), (d, True)):
        j, t = j.set(idx, val), t.set(idx, val)
        np.testing.assert_array_equal(u32(t.words), np.asarray(j.words))
    assert t == itt.PackedBinary(t.words, d) and t != itt.PackedBinary.zeros(d)
    assert itt.PackedBinary.zeros(d).count_ones() == 0
    with pytest.raises(ContractError, match="PackedBinary"):
        itt.PackedBinary(np.zeros(5, np.uint32), d)


def test_pair_ops_match_jax(rng):
    d = 77
    a, b = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
    ja, jb = it.encode_binary(a), it.encode_binary(b)
    ta, tb_ = itt.encode_binary(a), itt.encode_binary(b)
    for name in ("binary_hamming", "binary_dot", "binary_jaccard"):
        got, want = getattr(itt, name)(ta, tb_), getattr(it, name)(ja, jb)
        assert float(got) == float(want), name
    zero = itt.PackedBinary.zeros(d)
    assert float(itt.binary_jaccard(zero, zero)) == 1.0
    with pytest.raises(ContractError, match="binary_dot"):
        itt.binary_dot(ta, itt.PackedBinary.zeros(d + 1))


@pytest.mark.parametrize("d,k", [(32, 1), (77, 10), (256, 7), (288, 5)])
def test_binary_knn_matches_jax(rng, d, k):
    w = corpus(rng, d)
    q = w[7].copy()
    jc, ji = it.binary_knn(it.PackedBinary(q, d), it.PackedBinaryBatch(w, d), k)
    tc, ti = itt.binary_knn(itt.PackedBinary.from_numpy(q, d),
                            itt.PackedBinaryBatch.from_numpy(w, d), k)
    assert tc.dtype == np.uint32 and ti.dtype == np.int64
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ti, ji)
    assert ti[:3].tolist() == [7, 50, 900][:k]


@pytest.mark.parametrize("n_q,form", [(1, "words"), (5, "list"), (16, "batch")])
def test_binary_knn_batch_matches_jax(rng, n_q, form):
    d = 288  # W = 9: a ragged sublane chunk in the TPU kernel
    w = corpus(rng, d)
    qs = words(rng, (n_q, 9))
    qs[0] = w[7]
    jcorp, tcorp = it.PackedBinaryBatch(w, d), itt.PackedBinaryBatch.from_numpy(w, d)
    jq = {"words": qs, "list": [it.PackedBinary(q, d) for q in qs],
          "batch": it.PackedBinaryBatch(qs, d)}[form]
    tq = {"words": qs, "list": [itt.PackedBinary.from_numpy(q, d) for q in qs],
          "batch": itt.PackedBinaryBatch.from_numpy(qs, d)}[form]
    jc, ji = it.ops.binary.binary_knn_batch(jq, jcorp, 6)
    tc, ti = tb.binary_knn_batch(tq, tcorp, 6)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ti, ji)


def test_binary_knn_multi_pass(rng, monkeypatch):
    """k above the pass cap runs exclusion-bounded passes; the concatenation
    equals the JAX package's single selection."""
    monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
    d = 64
    w = corpus(rng, d)
    w[100:300] = w[7]  # ties across pass boundaries
    q = w[7].copy()
    jc, ji = it.binary_knn(it.PackedBinary(q, d), it.PackedBinaryBatch(w, d), 40)
    tc, ti = itt.binary_knn(itt.PackedBinary.from_numpy(q, d),
                            itt.PackedBinaryBatch.from_numpy(w, d), 40)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ti, ji)


def test_batch_binary_hamming_matches_jax(rng):
    d = 77
    w = corpus(rng, d)
    q = it.PackedBinary(w[7], d)
    want = np.asarray(it.batch_binary_hamming(q, w))
    got = itt.batch_binary_hamming(itt.PackedBinary.from_numpy(w[7], d), w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(itt.batch_binary_hamming(np.asarray(q.words), w).numpy(), want)


def test_knn_edges_and_contracts(rng):
    d = 64
    corp = itt.PackedBinaryBatch.from_numpy(words(rng, (10, 2)), d)
    q = itt.PackedBinary.zeros(d)
    counts, idx = itt.binary_knn(q, corp, 0)
    assert counts.shape == (0,) and idx.shape == (0,)
    assert len(itt.binary_knn(q, corp, 100)[1]) == 10
    assert tb.binary_knn_batch(np.zeros((3, 2), np.uint32), corp, 0)[1].shape == (3, 0)
    with pytest.raises(ContractError, match="binary_knn"):
        itt.binary_knn(itt.PackedBinary.zeros(d + 1), corp, 3)
    with pytest.raises(ContractError, match="binary_knn_batch"):
        tb.binary_knn_batch(np.zeros((3, 5), np.uint32), corp, 3)
    with pytest.raises(ContractError, match="batch_binary_hamming"):
        itt.batch_binary_hamming(np.zeros(3, np.uint32), np.zeros((4, 2), np.uint32))
    with pytest.raises(ContractError, match="PackedBinaryBatch"):
        itt.PackedBinaryBatch(np.zeros((4, 3), np.uint32), d)
