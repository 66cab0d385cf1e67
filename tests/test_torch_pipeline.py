"""innr_tpu_torch.pipeline.TwoStageIndex against innr_tpu.pipeline.

The same numpy rows and queries go to both packages at N = 2100 >=
MIN_ROWS_PALLAS, so the JAX package runs its Pallas kernels (interpret mode
on the CPU) in the coarse stage. Tolerances:
- binary and ternary shortlists are integer selections: equal to the JAX
  kernel's, and so are the final indices;
- final scores are float32 dots of the same rows in another summation
  order: within cond_tol (32 eps sum|q_i r_i|, tests/conftest.py), indices
  equal wherever the rank gap exceeds it (u8 and matryoshka shortlists are
  float selections too);
- recall on a small clustered corpus: equal to the JAX package's for
  binary and ternary.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from innr_tpu.kernels import packed_knn as jpk  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from test_torch_knn import EPS, assert_topk_agrees  # noqa: E402
from test_torch_packed_knn import N  # noqa: E402
from innr_tpu_torch import config as tconfig  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(previous)


D, Q, K = 96, 5, 7
KINDS = [("binary", 8), ("ternary", 8), ("u8", 3), ("matryoshka", 3)]


@pytest.fixture
def data(rng):
    rows = rng.standard_normal((N, D)).astype(np.float32)
    qs = rng.standard_normal((Q, D)).astype(np.float32)
    qs[0] = rows[11]
    tol = 32 * EPS * (np.abs(qs) @ np.abs(rows).T).max(axis=1, keepdims=True)
    return rows, qs, tol


def config(kind, package):
    if kind == "matryoshka":
        return package.CoarseConfig(kind=kind, prefix_dims=32)
    return package.CoarseConfig(kind=kind, threshold=0.1 if kind == "ternary" else 0.0)


def jax_shortlist(index, qs, n_cand):
    """The JAX coarse stage's candidates, from its Pallas kernel."""
    c, t = index._coarse, index.config.threshold
    if index.config.kind == "binary":
        q = it.encode_binary_batch(jnp.asarray(qs), t)
        return np.asarray(jpk.fused_binary_knn_batch(q, c.words_t, n_cand)[1])
    qp, qn = it.encode_ternary_batch(jnp.asarray(qs), t)
    return np.asarray(jpk.fused_ternary_knn_batch(qp, qn, c.pos_t, c.neg_t, n_cand)[1])


@pytest.mark.parametrize("kind,rf", KINDS)
def test_search_batch_matches_jax(data, kind, rf):
    rows, qs, tol = data
    j = it.TwoStageIndex(rows, config(kind, it), rerank_factor=rf)
    t = itt.TwoStageIndex(rows, config(kind, itt), rerank_factor=rf)
    assert t.memory_bytes() == j.memory_bytes()
    assert (t.num_vectors, t.dimension) == (N, D)
    if kind in ("binary", "ternary"):
        keys, cand = t.candidates(torch.from_numpy(qs), K * rf)
        np.testing.assert_array_equal(cand.numpy(), jax_shortlist(j, qs, K * rf))
    jr, tr = j.search_batch(qs, K), t.search_batch(qs, K)
    assert tr.indices.dtype == np.int64 and tr.scores.dtype == np.float32
    assert tr.indices.shape == (Q, K) and tr.indices[0, 0] == 11
    if kind in ("binary", "ternary"):
        np.testing.assert_array_equal(tr.indices, jr.indices)
        np.testing.assert_allclose(tr.scores, jr.scores, rtol=0, atol=tol.max())
    else:
        assert_topk_agrees(tr.scores, tr.indices, jr.scores, jr.indices, tol)


@pytest.mark.parametrize("kind,rf", KINDS[:2])
def test_single_search_matches_jax(data, kind, rf):
    rows, qs, tol = data
    j = it.TwoStageIndex(rows, config(kind, it), rerank_factor=rf)
    t = itt.TwoStageIndex(rows, config(kind, itt), rerank_factor=rf)
    jr, tr = j.search(qs[2], K), t.search(qs[2], K)
    assert tr.indices.shape == (K,)
    np.testing.assert_array_equal(tr.indices, jr.indices)
    np.testing.assert_allclose(tr.scores, jr.scores, rtol=0, atol=tol[2, 0])


@pytest.mark.parametrize("kind", ["binary", "ternary"])
def test_multi_pass_shortlist(data, monkeypatch, kind):
    """A shortlist above the pass cap (here 56 > 16: four passes) equals the
    JAX kernel's single selection."""
    monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
    rows, qs, _ = data
    j = it.TwoStageIndex(rows, config(kind, it), rerank_factor=8)
    t = itt.TwoStageIndex(rows, config(kind, itt), rerank_factor=8)
    _, cand = t.candidates(torch.from_numpy(qs), K * 8)
    np.testing.assert_array_equal(cand.numpy(), jax_shortlist(j, qs, K * 8))
    np.testing.assert_array_equal(t.search_batch(qs, K).indices, j.search_batch(qs, K).indices)


def test_recall_on_clustered_corpus_matches_jax(rng):
    """The clustered regime of the JAX bench (centers + noise), cut to
    2100 x 64 and 8 queries."""
    centers = rng.standard_normal((64, 64)).astype(np.float32)
    rows = centers[rng.integers(0, 64, N)] + 0.3 * rng.standard_normal((N, 64)).astype(np.float32)
    qs = rows[:8] + 0.05 * rng.standard_normal((8, 64)).astype(np.float32)
    for kind, rf in (("binary", 8), ("ternary", 8)):
        j = it.TwoStageIndex(rows, kind, rerank_factor=rf).recall_vs_exact(qs, 10)
        t = itt.TwoStageIndex(rows, kind, rerank_factor=rf).recall_vs_exact(qs, 10)
        assert t == j, kind
        assert 0.0 < t <= 1.0


def test_u8_quantile_fit_matches_jax(data):
    rows, qs, tol = data
    cfg = dict(kind="u8", quantile=0.9)
    j = it.TwoStageIndex(rows, it.CoarseConfig(**cfg), rerank_factor=3)
    t = itt.TwoStageIndex(rows, itt.CoarseConfig(**cfg), rerank_factor=3)
    assert t.params == itt.QuantizationParams(j.params.alpha, j.params.offset)
    np.testing.assert_array_equal(t._coarse.codes.numpy(), np.asarray(j._coarse.codes))
    jr, tr = j.search_batch(qs, K), t.search_batch(qs, K)
    assert_topk_agrees(tr.scores, tr.indices, jr.scores, jr.indices, tol)


def test_rerank_is_exact_within_the_shortlist(data):
    rows, qs, _ = data
    t = itt.TwoStageIndex(rows, "binary", rerank_factor=N)  # the shortlist is the corpus
    exact = itt.batch_knn_dot(qs, itt.VerticalBatch(rows), K).indices
    np.testing.assert_array_equal(t.search_batch(qs, K).indices, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rf", KINDS)
def test_kernels_match_plain_on_cuda(data, kind, rf):
    """On the card the coarse stage runs the kernels; its shortlist and the
    results equal the plain version's (integer-valued rows: every dot is
    exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    rows, qs, _ = data
    rows, qs = np.round(4 * rows), np.round(4 * qs)
    t = itt.TwoStageIndex(rows, config(kind, itt), rerank_factor=rf, device="cuda")
    q = torch.from_numpy(qs).cuda()
    got = t.candidates(q, K * rf), t.search_batch(qs, K)
    itt.config.force_reference(True)
    try:
        want = t.candidates(q, K * rf), t.search_batch(qs, K)
    finally:
        itt.config.force_reference(False)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    np.testing.assert_array_equal(got[1].indices, want[1].indices)


def test_edges_and_contracts(data):
    rows, qs, _ = data
    t = itt.TwoStageIndex(rows[:30], "binary", rerank_factor=4)
    assert t.search_batch(qs, 0).indices.shape == (Q, 0)
    assert t.search_batch(qs[:0], 3).indices.shape == (0, 0)
    assert t.search(qs[0], 0).indices.shape == (0,)
    assert t.search_batch(qs, 100).indices.shape == (Q, 30)  # k capped at N
    with pytest.raises(ContractError, match="unknown coarse kind"):
        itt.TwoStageIndex(rows, "nope")
    with pytest.raises(ContractError, match="rerank_factor"):
        itt.TwoStageIndex(rows, "binary", rerank_factor=0)
    with pytest.raises(ContractError, match="2-D"):
        itt.TwoStageIndex(rows[0], "binary")
    with pytest.raises(ContractError, match="search_batch"):
        t.search_batch(qs[:, :5], 3)
    with pytest.raises(ContractError, match="search"):
        t.search(qs, 3)
