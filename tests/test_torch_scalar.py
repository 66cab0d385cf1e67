"""innr_tpu_torch.ops.scalar against innr_tpu.ops.scalar.

Quantization codes: exact. u8 kNN on integer-valued queries: exact (every
mixed dot is an exact integer). On Gaussian queries: scores within
1e-5 sum|q_i c_i| + cond_tol (the TPU kernel splits the query into hi/lo
bf16 halves, ~2^-18 relative per product), indices equal wherever the rank
gap exceeds that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu.ops.scalar as js  # noqa: E402
import innr_tpu_torch.ops.scalar as ts  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from test_torch_knn import EPS, assert_topk_agrees  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


@pytest.fixture
def values(rng):
    v = rng.standard_normal((300, 24)).astype(np.float32)
    # exact half-way points of the code grid exercise the rounding rule
    params = js.QuantizationParams.from_range(-2.0, 2.0)
    v[0, :] = (np.arange(24, dtype=np.float32) + 0.5) / 255 * params.alpha + params.offset
    return v


@pytest.mark.parametrize("fit", ["fit", "fit_vectors", "quantile"])
def test_params_match(values, fit):
    if fit == "quantile":
        got = ts.QuantizationParams.fit_quantile(values, 0.99)
        want = js.QuantizationParams.fit_quantile(values, 0.99)
    else:
        got = getattr(ts.QuantizationParams, fit)(values)
        want = getattr(js.QuantizationParams, fit)(values)
    assert (got.alpha, got.offset) == (want.alpha, want.offset)


@pytest.mark.parametrize("form", ["tensor", "list", "float64", "nan"])
def test_fit_input_forms(values, form):
    """fit reduces every input form (on a tensor's own device) to the JAX
    package's float32 min/max; NaN propagates as numpy's does."""
    if form == "nan":
        values = values.copy()
        values[5, 7] = np.nan
    data = {"tensor": torch.from_numpy(values), "list": values.tolist(),
            "float64": values.astype(np.float64), "nan": values}[form]
    got = ts.QuantizationParams.fit(data)
    want = js.QuantizationParams.fit(values)
    np.testing.assert_array_equal([got.alpha, got.offset], [want.alpha, want.offset])


def test_params_edges():
    assert ts.QuantizationParams.fit([]) == ts.QuantizationParams(1.0, 0.0)
    assert ts.QuantizationParams.from_range(3.0, 3.0).alpha == 1.0
    assert ts.QuantizationParams.fit_quantile([np.nan, np.inf], 0.5) == ts.QuantizationParams(1.0, 0.0)
    with pytest.raises(ContractError):
        ts.QuantizationParams.fit_quantile([1.0], 0.0)


@pytest.mark.parametrize("lo,hi", [(-2.0, 2.0), (-0.7, 3.1)])
def test_codes_exact(values, lo, hi):
    params = ts.QuantizationParams.from_range(lo, hi)
    got = ts.QuantizedU8Batch.quantize(values, params).codes.numpy()
    want = np.asarray(js.QuantizedU8Batch.quantize(values, js.QuantizationParams(params.alpha, params.offset)).codes)
    np.testing.assert_array_equal(got, want)
    one = ts.quantize_u8(values[0], params).codes.numpy()
    np.testing.assert_array_equal(one, want[0])


def test_asymmetric_dots(values, rng):
    params = ts.QuantizationParams.fit(values)
    jparams = js.QuantizationParams(params.alpha, params.offset)
    q = rng.standard_normal(24).astype(np.float32)
    tq, jq = ts.quantize_u8(values[3], params), js.quantize_u8(values[3], jparams)
    ctx = ts.query_context(q)
    assert ctx.query_sum == pytest.approx(js.query_context(q).query_sum, rel=1e-6)
    for got, want in [
        (ts.asymmetric_dot_u8(q, tq, params), js.asymmetric_dot_u8(q, jq, jparams)),
        (ts.asymmetric_dot_u8_precomputed(q, tq, params, ctx),
         js.asymmetric_dot_u8_precomputed(q, jq, jparams, js.query_context(q))),
        (ts.mixed_dot_u8_f32(q, tq.codes), js.mixed_dot_u8_f32(q, jq.codes)),
    ]:
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-5)
    with pytest.raises(ContractError, match="mixed_dot_u8_f32"):
        ts.mixed_dot_u8_f32(q[:5], tq.codes)
    with pytest.raises(ContractError, match="asymmetric_dot_u8"):
        ts.asymmetric_dot_u8(q[:5], tq, params)
    with pytest.raises(ContractError):
        ts.QuantizedU8(np.zeros(4, np.uint8), dimension=5)


@pytest.mark.parametrize("n", [2100, 500])
def test_batch_knn_u8_integer_queries_exact(rng, n):
    codes = rng.integers(0, 256, (n, 20)).astype(np.uint8)
    q = rng.integers(-4, 5, 20).astype(np.float32)
    params = ts.QuantizationParams(alpha=255.0, offset=0.0)
    got = ts.batch_knn_u8(q, ts.QuantizedU8Batch(codes), params, 9)
    want = js.batch_knn_u8(q, js.QuantizedU8Batch(codes), js.QuantizationParams(255.0, 0.0), 9)
    assert got == want


def test_batch_knn_u8_multi_gaussian(rng):
    codes = rng.integers(0, 256, (2100, 32)).astype(np.uint8)
    qs = rng.standard_normal((3, 32)).astype(np.float32)
    params = ts.QuantizationParams.from_range(-1.5, 2.0)
    jparams = js.QuantizationParams(params.alpha, params.offset)
    tv, ti = ts.batch_knn_u8_multi(qs, ts.QuantizedU8Batch(codes), params, 8)
    jv, ji = js.batch_knn_u8_multi(qs, js.QuantizedU8Batch(codes), jparams, 8)
    scale = params.alpha / 255.0
    cond = (np.abs(qs) @ codes.T.astype(np.float64)).max(axis=1, keepdims=True)
    tol = scale * (1e-5 * cond + 32 * EPS * cond) + 32 * EPS * abs(params.offset) * np.abs(qs).sum(1, keepdims=True)
    assert_topk_agrees(tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji), tol)


def test_batch_knn_u8_list_corpus_and_edges(rng):
    codes = rng.integers(0, 256, (40, 6)).astype(np.uint8)
    q = rng.standard_normal(6).astype(np.float32)
    params = ts.QuantizationParams(1.0, 0.0)
    as_batch = ts.batch_knn_u8(q, ts.QuantizedU8Batch(codes), params, 5)
    as_list = ts.batch_knn_u8(q, [ts.QuantizedU8(c) for c in codes], params, 5)
    assert as_batch == as_list
    assert ts.batch_knn_u8(q, [], params, 5) == []
    assert ts.batch_knn_u8(q, ts.QuantizedU8Batch(codes), params, 0) == []
    assert len(ts.batch_knn_u8(q, ts.QuantizedU8Batch(codes), params, 99)) == 40
    with pytest.raises(ContractError, match="batch_knn_u8"):
        ts.batch_knn_u8(q[:4], ts.QuantizedU8Batch(codes), params, 3)
    v, i = ts.batch_knn_u8_multi(q[None, :], ts.QuantizedU8Batch(codes), params, 0)
    assert v.shape == (1, 0) and i.shape == (1, 0)
    with pytest.raises(ContractError, match="batch_knn_u8_multi"):
        ts.batch_knn_u8_multi(q, ts.QuantizedU8Batch(codes), params, 3)
    with pytest.raises(ContractError):
        ts.QuantizedU8Batch(np.zeros(4, np.uint8))
    b = ts.QuantizedU8Batch.from_numpy(codes)
    assert (b.num_vectors, b.dimension, b.memory_bytes()) == (40, 6, 240)
