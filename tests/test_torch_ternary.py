"""innr_tpu_torch.ops.ternary against innr_tpu.ops.ternary.

The same numpy inputs build both packages' state (the port's int32 planes
are the JAX package's uint32 planes, bit for bit). The kNN and per-row
functions run at N = 2100 >= MIN_ROWS_PALLAS, so the JAX package takes its
Pallas kernels (interpret mode on the CPU) and the port its kernels' plain
versions. Integer results are equal. The f32 asymmetric dots are held to
cond_tol (tests/conftest.py): both sum float32 products of the query with
{-1, 0, +1} in their own order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from conftest import cond_tol  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.ops import ternary as tt  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from test_torch_binary import u32  # noqa: E402
from test_torch_packed_knn import N, ternary_data  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def planes_of(obj):
    return [u32(obj.pos), u32(obj.neg)]


def corpus(rng, d, n=N, n_q=1):
    """((qpos, qneg), (pos, neg)) for D = d (padding bits left set: the
    constructors clear them); rows 50 and 900 copy row 7, query 0 is row 7."""
    return ternary_data(rng, -(-d // 32), n_q, n)


@pytest.mark.parametrize("d", [1, 31, 32, 33, 77, 96])
def test_encode_matches_jax(rng, d):
    rows = rng.standard_normal((40, d)).astype(np.float32)
    rows[0, 0] = np.nan
    rows[1, :] = 0.5  # equal to the threshold -> 0 (strict on both sides)
    rows[2, :] = -0.5
    for got, want in zip(itt.encode_ternary_batch(rows, 0.5), it.encode_ternary_batch(rows, 0.5)):
        np.testing.assert_array_equal(u32(got), np.asarray(want))
    t, j = itt.encode_ternary(rows[3], 0.5), it.encode_ternary(rows[3], 0.5)
    for got, want in zip(planes_of(t), planes_of(j)):
        np.testing.assert_array_equal(got, want)
    tbatch, jbatch = itt.PackedTernaryBatch.encode(rows, 0.5), it.PackedTernaryBatch.encode(rows, 0.5)
    for name in ("pos", "neg", "pos_t", "neg_t"):
        np.testing.assert_array_equal(u32(getattr(tbatch, name)), np.asarray(getattr(jbatch, name)))
    assert tbatch.memory_bytes() == jbatch.memory_bytes()
    assert (tbatch.num_vectors, tbatch.dimension) == (40, d)


@pytest.mark.parametrize("d", [5, 32, 77])
def test_packed_ternary_state(rng, d):
    (qp, qn), _ = corpus(rng, d, n=1000)
    j, t = it.PackedTernary(qp[0], qn[0], d), itt.PackedTernary.from_numpy(qp[0], qn[0], d)
    for got, want in zip(planes_of(t), planes_of(j)):
        np.testing.assert_array_equal(got, want)
    assert t.nnz() == j.nnz() and t.memory_bytes() == j.memory_bytes()
    assert itt.sparsity(t) == it.sparsity(j)
    np.testing.assert_array_equal(t.to_values().numpy(), np.asarray(j.to_values()))
    np.testing.assert_array_equal(t.to_interleaved_u64(), j.to_interleaved_u64())
    assert itt.PackedTernary.from_interleaved_u64(j.to_interleaved_u64(), d) == t
    assert [t.get(i) for i in range(-1, d + 1)] == [j.get(i) for i in range(-1, d + 1)]
    for idx, val in ((0, 1), (d - 1, -1), (d - 1, 0), (min(31, d - 1), -1), (d, 1)):
        j, t = j.set(idx, val), t.set(idx, val)
        for got, want in zip(planes_of(t), planes_of(j)):
            np.testing.assert_array_equal(got, want)
    z = itt.PackedTernary.zeros(d)
    assert z.nnz() == 0 and itt.sparsity(z) == 1.0 and t != z
    with pytest.raises(ContractError, match="both planes"):
        itt.PackedTernary(np.ones(1, np.uint32), np.ones(1, np.uint32), 1)
    with pytest.raises(ContractError, match="plane lengths"):
        itt.PackedTernary(np.zeros(5, np.uint32), np.zeros(5, np.uint32), d)


def test_pair_ops_match_jax(rng):
    d = 77
    a, b, q = (rng.standard_normal(d).astype(np.float32) for _ in range(3))
    ja, jb = it.encode_ternary(a, 0.3), it.encode_ternary(b, 0.3)
    ta, tb_ = itt.encode_ternary(a, 0.3), itt.encode_ternary(b, 0.3)
    assert int(itt.ternary_dot(ta, tb_)) == int(it.ternary_dot(ja, jb))
    assert int(itt.ternary_hamming(ta, tb_)) == int(it.ternary_hamming(ja, jb))
    got, want = float(itt.asymmetric_dot(q, ta)), float(it.asymmetric_dot(q, ja))
    assert abs(got - want) <= cond_tol(q, np.ones(d))
    with pytest.raises(ContractError, match="ternary_dot"):
        itt.ternary_dot(ta, itt.PackedTernary.zeros(d + 1))
    with pytest.raises(ContractError, match="asymmetric_dot"):
        itt.asymmetric_dot(q[:5], ta)


@pytest.mark.parametrize("d,k", [(32, 1), (77, 10), (288, 7)])
def test_ternary_knn_matches_jax(rng, d, k):
    (qp, qn), (pos, neg) = corpus(rng, d)
    jd, ji = it.ternary_knn(it.PackedTernary(qp[0], qn[0], d), it.PackedTernaryBatch(pos, neg, d), k)
    td, ti = itt.ternary_knn(itt.PackedTernary.from_numpy(qp[0], qn[0], d),
                             itt.PackedTernaryBatch.from_numpy(pos, neg, d), k)
    assert td.dtype == np.int32 and ti.dtype == np.int64
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("n_q,form", [(1, "planes"), (5, "list"), (16, "batch")])
def test_ternary_knn_batch_matches_jax(rng, n_q, form):
    d = 288  # W = 9: a ragged sublane chunk in the TPU kernel
    (qp, qn), (pos, neg) = corpus(rng, d, n_q=n_q)
    jcorp = it.PackedTernaryBatch(pos, neg, d)
    tcorp = itt.PackedTernaryBatch.from_numpy(pos, neg, d)
    jq = {"planes": (qp, qn), "list": [it.PackedTernary(a, b, d) for a, b in zip(qp, qn)],
          "batch": it.PackedTernaryBatch(qp, qn, d)}[form]
    tq = {"planes": (qp, qn),
          "list": [itt.PackedTernary.from_numpy(a, b, d) for a, b in zip(qp, qn)],
          "batch": itt.PackedTernaryBatch.from_numpy(qp, qn, d)}[form]
    jd, ji = it.ops.ternary.ternary_knn_batch(jq, jcorp, 6)
    td, ti = tt.ternary_knn_batch(tq, tcorp, 6)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ti, ji)


def test_ternary_knn_multi_pass(rng, monkeypatch):
    monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
    d = 64
    (qp, qn), (pos, neg) = corpus(rng, d)
    pos[100:300], neg[100:300] = pos[7], neg[7]  # ties across pass boundaries
    jd, ji = it.ternary_knn(it.PackedTernary(qp[0], qn[0], d), it.PackedTernaryBatch(pos, neg, d), 40)
    td, ti = itt.ternary_knn(itt.PackedTernary.from_numpy(qp[0], qn[0], d),
                             itt.PackedTernaryBatch.from_numpy(pos, neg, d), 40)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ti, ji)


def test_batch_ternary_dot_matches_jax(rng):
    d = 77
    (qp, qn), (pos, neg) = corpus(rng, d)
    want = np.asarray(it.batch_ternary_dot(it.PackedTernary(qp[0], qn[0], d), pos, neg))
    got = itt.batch_ternary_dot(itt.PackedTernary.from_numpy(qp[0], qn[0], d), pos, neg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_asymmetric_dot_matches_jax(rng):
    d = 77
    rows = rng.standard_normal((N, d)).astype(np.float32)
    q = rng.standard_normal(d).astype(np.float32)
    jpos, jneg = it.encode_ternary_batch(rows, 0.4)
    want = np.asarray(it.batch_asymmetric_dot(q, jpos, jneg, d))
    tpos, tneg = itt.encode_ternary_batch(rows, 0.4)
    got = itt.batch_asymmetric_dot(q, tpos, tneg, d)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=cond_tol(q, np.ones(d)))


def test_knn_edges_and_contracts(rng):
    d = 64
    _, (pos, neg) = corpus(rng, d, n=1000)
    corp = itt.PackedTernaryBatch.from_numpy(pos[:10], neg[:10], d)
    q = itt.PackedTernary.zeros(d)
    dots, idx = itt.ternary_knn(q, corp, 0)
    assert dots.shape == (0,) and idx.shape == (0,)
    assert len(itt.ternary_knn(q, corp, 100)[1]) == 10
    assert tt.ternary_knn_batch([q, q], corp, 0)[1].shape == (2, 0)
    with pytest.raises(ContractError, match="ternary_knn"):
        itt.ternary_knn(itt.PackedTernary.zeros(d + 1), corp, 3)
    with pytest.raises(ContractError, match="ternary_knn_batch"):
        tt.ternary_knn_batch((np.zeros((3, 5), np.uint32),) * 2, corp, 3)
    with pytest.raises(ContractError, match="PackedTernaryBatch"):
        itt.PackedTernaryBatch(pos[:4], neg[:5], d)
