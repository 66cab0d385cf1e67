"""The ported slice end to end against innr_tpu's public batch functions.

N = 2100 runs innr_tpu's Pallas kernel (interpret mode), N = 500 its XLA
path; the port runs its plain versions on CPU tensors. Integer-valued data
(with a planted NaN row): scores and indices exact. Gaussian data: scores
within cond_tol, indices equal wherever the rank gap exceeds it; cosine
within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from innr_tpu_torch import backend, config  # noqa: E402
from test_torch_knn import EPS, assert_topk_agrees  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


KNN = ("batch_knn", "batch_knn_dot", "batch_knn_cosine")


def int_corpus(rng, n, d=16):
    rows = rng.integers(-4, 5, (n, d)).astype(np.float32)
    rows[13] = np.nan
    return rows


def both(rows):
    return it.VerticalBatch.from_rows(rows), itt.VerticalBatch.from_rows(rows)


def assert_same(a, b, tol=None):
    assert a.indices.shape == b.indices.shape
    assert b.indices.dtype == np.int64 and b.scores.dtype == np.float32
    if tol is None:
        np.testing.assert_array_equal(b.indices, a.indices)
        np.testing.assert_array_equal(b.scores, a.scores)
    else:
        assert_topk_agrees(b.scores, b.indices, a.scores, a.indices, tol)


class TestVerticalBatch:
    def test_constructors_and_accessors(self, rng):
        rows = rng.standard_normal((7, 5)).astype(np.float32)
        jb = it.VerticalBatch.from_rows(rows)
        for tb in (itt.VerticalBatch.from_rows(rows),
                   itt.VerticalBatch.from_rows([list(r) for r in rows]),
                   itt.VerticalBatch.from_slices(rows),
                   itt.VerticalBatch.from_flat(rows.reshape(-1), 7, 5),
                   itt.VerticalBatch.from_numpy(rows)):
            assert (tb.num_vectors, tb.dimension) == (jb.num_vectors, jb.dimension)
            assert tb.get(3, 6) == jb.get(3, 6)
            np.testing.assert_array_equal(tb.dimension_slice(2).numpy(),
                                          np.asarray(jb.dimension_slice(2)))
            np.testing.assert_array_equal(tb.extract_vector(4).numpy(),
                                          np.asarray(jb.extract_vector(4)))
            np.testing.assert_array_equal(tb.data(), jb.data())
        assert tb.data()[1 * 7 + 2] == rows[2, 1]  # dimension-major order

    def test_empty_and_contract_errors(self):
        assert itt.VerticalBatch.from_rows([]).num_vectors == 0
        with pytest.raises(itt.ContractError, match="inconsistent"):
            itt.VerticalBatch.from_rows([[1.0, 2.0], [1.0]])
        with pytest.raises(itt.ContractError, match="from_flat"):
            itt.VerticalBatch.from_flat(np.ones(5), 2, 3)
        with pytest.raises(itt.ContractError, match="2-D"):
            itt.VerticalBatch(np.ones(4))
        with pytest.raises(itt.ContractError, match="dtype"):
            itt.VerticalBatch(np.ones((2, 2)), dtype=torch.float16)

    def test_bf16_storage_rounds_like_jax(self, rng):
        import jax.numpy as jnp

        rows = rng.standard_normal((9, 4)).astype(np.float32)
        jb = it.VerticalBatch(rows, dtype=jnp.bfloat16)
        tb = itt.VerticalBatch(rows, dtype=torch.bfloat16)
        assert tb.rows.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tb.rows.view(torch.uint16).numpy(), np.asarray(jb.rows).view(np.uint16))
        again = itt.VerticalBatch.from_numpy(np.asarray(jb.rows), dtype=torch.bfloat16)
        assert torch.equal(again.rows.view(torch.uint16), tb.rows.view(torch.uint16))

    def test_norm_caches(self, rng):
        rows = rng.standard_normal((30, 6)).astype(np.float32)
        rows[3] = 0.0
        jb, tb = both(rows)
        np.testing.assert_allclose(tb.norms2().numpy(), np.asarray(jb.norms2()), rtol=1e-6)
        np.testing.assert_allclose(tb.inv_norms().numpy(), np.asarray(jb.inv_norms()), rtol=1e-6)
        assert tb.norms2() is tb.norms2() and tb.inv_norms()[3] == 0.0


class TestBatchScores:
    @pytest.fixture
    def data(self, rng):
        rows = rng.standard_normal((40, 9)).astype(np.float32)
        rows[5] = 0.0
        return rows, rng.standard_normal(9).astype(np.float32)

    @pytest.mark.parametrize("name", [
        "batch_dot", "batch_dot_into", "batch_l2_squared", "batch_l2_squared_into",
        "batch_cosine", "batch_cosine_into",
    ])
    def test_query_scores(self, data, name):
        rows, q = data
        jb, tb = both(rows)
        got = getattr(itt, name)(q, tb).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(it, name)(q, jb)),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("name", ["batch_norms", "batch_norms_into",
                                      "batch_dimension_variance"])
    def test_corpus_scores(self, data, name):
        jb, tb = both(data[0])
        np.testing.assert_allclose(getattr(itt, name)(tb).numpy(),
                                   np.asarray(getattr(it, name)(jb)), rtol=1e-5)

    def test_cosine_with_norms_and_zero_query(self, data):
        rows, q = data
        jb, tb = both(rows)
        norms = itt.batch_norms(tb)
        np.testing.assert_allclose(itt.batch_cosine(q, tb, norms).numpy(),
                                   np.asarray(it.batch_cosine(q, jb)), rtol=1e-5, atol=1e-6)
        assert (itt.batch_cosine(np.zeros(9), tb).numpy() == 0.0).all()
        with pytest.raises(itt.ContractError, match="norms length"):
            itt.batch_cosine(q, tb, norms[:3])

    def test_query_shape_errors(self, data):
        rows, q = data
        _, tb = both(rows)
        with pytest.raises(itt.ContractError, match="batch_dot"):
            itt.batch_dot(q[:4], tb)
        with pytest.raises(itt.ContractError, match="batch_l2_squared"):
            itt.batch_l2_squared(np.stack([q, q]), tb)


class TestKnn:
    @pytest.mark.parametrize("n", [2100, 500])
    @pytest.mark.parametrize("name", ("batch_knn", "batch_knn_dot"))
    def test_integer_exact_single_and_batched(self, rng, n, name):
        rows = int_corpus(rng, n)
        qs = rng.integers(-4, 5, (3, 16)).astype(np.float32)
        jb, tb = both(rows)
        assert_same(getattr(it, name)(qs, jb, 9), getattr(itt, name)(qs, tb, 9))
        assert_same(getattr(it, name)(qs[1], jb, 9), getattr(itt, name)(qs[1], tb, 9))

    @pytest.mark.parametrize("n", [2100, 500])
    def test_cosine(self, rng, n):
        rows = int_corpus(rng, n)
        rows[20] = 0.0
        if n < 2048:
            # innr_tpu's XLA cosine path scores a NaN row 0.0, its fused
            # kernel (and the port) NaN: compare the XLA path without one.
            rows[13] = 1.0
        qs = rng.integers(-4, 5, (3, 16)).astype(np.float32)
        jb, tb = both(rows)
        assert_same(it.batch_knn_cosine(qs, jb, 9), itt.batch_knn_cosine(qs, tb, 9), 1e-5)
        assert_same(it.batch_knn_cosine(qs[0], jb, 9), itt.batch_knn_cosine(qs[0], tb, 9), 1e-5)

    def test_gaussian_within_cond_tol(self, rng):
        rows = rng.standard_normal((2100, 24)).astype(np.float32)
        qs = rng.standard_normal((4, 24)).astype(np.float32)
        jb, tb = both(rows)
        dot_tol = 32 * EPS * (np.abs(qs) @ np.abs(rows).T).max(axis=1, keepdims=True)
        l2_tol = 32 * EPS * ((rows * rows).sum(1).max() + (qs * qs).sum(1, keepdims=True))
        assert_same(it.batch_knn_dot(qs, jb, 6), itt.batch_knn_dot(qs, tb, 6), dot_tol)
        assert_same(it.batch_knn(qs, jb, 6), itt.batch_knn(qs, tb, 6), l2_tol + 2 * dot_tol)

    @pytest.mark.parametrize("n", [2100, 500])
    def test_filtered_mask_and_callable(self, rng, n):
        rows = int_corpus(rng, n)
        qs = rng.integers(-4, 5, (2, 16)).astype(np.float32)
        mask = rng.random(n) < 0.5
        jb, tb = both(rows)
        assert_same(it.batch_knn_filtered(qs, jb, 8, mask),
                    itt.batch_knn_filtered(qs, tb, 8, mask))
        got = itt.batch_knn_filtered(qs[0], tb, 8, lambda i: i % 3 == 0)
        assert_same(it.batch_knn_filtered(qs[0], jb, 8, lambda i: i % 3 == 0), got)
        assert (got.indices % 3 == 0).all()

    def test_filtered_fewer_passing_than_k(self, rng):
        rows = int_corpus(rng, 2100)
        mask = np.zeros(2100, dtype=bool)
        mask[[4, 900, 2099]] = True
        jb, tb = both(rows)
        got = itt.batch_knn_filtered(rows[7], tb, 10, mask)
        assert sorted(got.indices.tolist()) == [4, 900, 2099]
        assert_same(it.batch_knn_filtered(rows[7], jb, 10, mask), got)
        none = itt.batch_knn_filtered(rows[7], tb, 10, np.zeros(2100, dtype=bool))
        assert none.indices.shape == (0,)
        with pytest.raises(itt.ContractError, match="mask shape"):
            itt.batch_knn_filtered(rows[7], tb, 3, mask[:10])

    @pytest.mark.parametrize("name", KNN)
    def test_k_zero_empty_corpus_and_k_above_n(self, rng, name):
        rows = int_corpus(rng, 40)
        fn = getattr(itt, name)
        _, tb = both(rows)
        assert fn(rows[0], tb, 0).indices.shape == (0,)
        assert fn(rows[:3], tb, 0).indices.shape == (3, 0)
        empty = itt.VerticalBatch(np.zeros((0, 16), np.float32))
        assert fn(rows[:2], empty, 4).scores.shape == (2, 0)
        res = fn(rows[:2], tb, 100)
        assert res.indices.shape == (2, 40)
        assert sorted(res.indices[0].tolist()) == list(range(40))

    @pytest.mark.parametrize("name", KNN + ("batch_knn_filtered",))
    def test_query_contract_errors(self, rng, name):
        _, tb = both(int_corpus(rng, 40))
        args = (np.ones(40, dtype=bool),) if name == "batch_knn_filtered" else ()
        with pytest.raises(itt.ContractError, match=name):
            getattr(itt, name)(np.ones(15, np.float32), tb, 3, *args)
        with pytest.raises(itt.ContractError, match=name):
            getattr(itt, name)(np.ones((2, 2, 16), np.float32), tb, 3, *args)

    def test_zero_norm_cosine_query_ties_go_low(self, rng):
        rows = rng.standard_normal((2100, 8)).astype(np.float32)
        jb, tb = both(rows)
        got = itt.batch_knn_cosine(np.zeros(8, np.float32), tb, 5)
        assert got.indices.tolist() == [0, 1, 2, 3, 4]
        assert (got.scores == 0.0).all()
        assert_same(it.batch_knn_cosine(np.zeros(8, np.float32), jb, 5), got)

    def test_bf16_corpus_matches_jax_exactly_on_integers(self, rng):
        import jax.numpy as jnp

        rows = int_corpus(rng, 2100)
        qs = rng.integers(-4, 5, (2, 16)).astype(np.float32)
        jb = it.VerticalBatch(rows, dtype=jnp.bfloat16)
        tb = itt.VerticalBatch(rows, dtype=torch.bfloat16)
        assert_same(it.batch_knn_dot(qs, jb, 7), itt.batch_knn_dot(qs, tb, 7))
        assert_same(it.batch_knn(qs, jb, 7), itt.batch_knn(qs, tb, 7))


class TestDispatch:
    def test_backend_on_cpu_and_forced(self, monkeypatch):
        assert backend.batch_backend(10, "cpu") is backend.Backend.TORCH
        assert str(backend.batch_backend(10**7, torch.device("cpu"))) == "torch"
        assert str(backend.Backend.CUDA) == "cuda"
        monkeypatch.setattr(config, "_FORCE_REFERENCE", True)
        assert backend.batch_backend(10, "cpu") is backend.Backend.REFERENCE
        assert str(backend.batch_backend(10, "cuda")) == "reference"

    def test_force_reference_same_results(self, rng):
        rows = int_corpus(rng, 300)
        _, tb = both(rows)
        before = itt.batch_knn(rows[:2], tb, 5)
        config.force_reference(True)
        try:
            assert config.reference_forced()
            forced = itt.batch_knn(rows[:2], tb, 5)
        finally:
            config.force_reference(False)
        assert_same(before, forced)

    def test_matmul_precision_knob(self):
        assert config.matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is False
        with pytest.raises(ValueError):
            config.set_matmul_precision("fast")


def _host_constructors():
    """Constructors and loaders given host data and no device."""
    import innr_tpu_torch.io as tio

    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    words = np.arange(6, dtype=np.uint32).reshape(3, 2)

    def load(tmp_path):
        path = str(tmp_path / "s.npz")
        np.savez(path, kind="SketchCorpus", sketches=words)
        return tio.load_npz(path).sketches

    return {
        "VerticalBatch": lambda _: itt.VerticalBatch(rows).rows,
        "VerticalBatch.from_rows": lambda _: itt.VerticalBatch.from_rows(rows.tolist()).rows,
        "PackedBinaryBatch": lambda _: itt.PackedBinaryBatch.from_numpy(words, 64).words,
        "PackedTernary.zeros": lambda _: itt.PackedTernary.zeros(40).pos,
        "QuantizedU8Batch": lambda _: itt.QuantizedU8Batch(rows.astype(np.uint8)).codes,
        "TileSummary": lambda _: itt.TileSummary.from_numpy(128, rows, rows[:, 0], [1, 1, 1],
                                                            3).centroids,
        "SketchCorpus": lambda _: itt.SketchCorpus(words).slots_t,
        "SparseCorpus": lambda _: itt.SparseCorpus([([1, 5], [1.0, 2.0])]).indices,
        "load_npz": load,
    }


class TestDefaultDevice:
    """Host data without a device goes to the card, as the JAX package puts
    host arrays on its accelerator; without a card that raises, with no
    fallback. A tensor keeps its device."""

    @pytest.mark.parametrize("name", sorted(_host_constructors()))
    def test_host_data_goes_to_the_card_or_raises(self, tmp_path, name):
        make = _host_constructors()[name]
        previous = config.set_default_device("cuda")
        try:
            if torch.cuda.is_available():
                assert make(tmp_path).device.type == "cuda"
            else:
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    make(tmp_path)
        finally:
            config.set_default_device(previous)

    def test_numpy_vertical_batch_raises_without_a_card(self, rng):
        if torch.cuda.is_available():
            pytest.skip("a card is present: host data lands there (previous test)")
        assert config.set_default_device("cuda") == torch.device("cpu")
        try:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                itt.VerticalBatch(rng.standard_normal((4, 3)).astype(np.float32))
            cpu = torch.ones(4, 3)
            assert itt.VerticalBatch(cpu).rows.device == cpu.device  # a tensor stays
        finally:
            config.set_default_device("cpu")

    def test_explicit_device_and_the_default(self):
        assert config.default_device() == torch.device("cpu")  # this file's fixture
        rows = np.ones((2, 3), np.float32)
        assert itt.VerticalBatch(rows).rows.device.type == "cpu"
        assert itt.VerticalBatch(rows, device="cpu").rows.device.type == "cpu"
        previous = config.set_default_device("meta")
        try:
            assert itt.VerticalBatch(rows).rows.device.type == "meta"
        finally:
            assert config.set_default_device(previous) == torch.device("meta")
