"""The f32 MaxSim kernel's gate (``csrc/maxsim.cu``) and its margin
(``innr_tpu_torch.kernels.maxsim_kernel.maxsim_margin``), emulated on the
CPU.

The kernel scores every (query token, document token) pair on the tensor
cores in TF32, keeps per query token L = max (s~ - T) over the tokens seen
so far (chunk by chunk; T = kq X + abs with X the chunk's largest token
norm), re-scores every token with s~ + T >= L exactly, and takes each query
token's best from those. These tests emulate the approximate dots in
float64 from the operands' TF32 truncations, each pushed by the tensor
core's worst accumulation error in the direction that hurts (every exact
best of a query token down, every other token up), build T from the
kernel's pieces (``maxsim_query_terms``, ``maxsim_margin``, token norms
summed in float32), and check that

- the exact best of every query token is always among the candidates, so
  the emulated kernel's scores equal the plain version's bit for bit on
  integer tokens, and the JAX package's Pallas kernel
  (``fused_maxsim_scores_batch``, interpret mode) bit for bit on integer
  tokens and within cond_tol (32 eps of the largest sum of |products|) on
  Gaussian tokens;
- a margin cut 8 times loses bests on near ties at a depth where the
  accumulation error matters, so the check is not vacuous.

Data: odd-integer tokens 2049-4095 that TF32 truncates with planted near
ties (TF32 dots tie, exact dots differ by 1-3), tokens with every low
mantissa bit set, Gaussian tokens with NaN / +-inf tokens, masks with a
fully masked document, a query token that holds inf.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from innr_tpu.kernels import maxsim_kernel as jmk  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import maxsim_kernel as tmk  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


EPS = float(np.finfo(np.float32).eps)
CHUNK = 64  # csrc/maxsim.cu: document tokens per wgmma


def _tf32(a):
    """float32 values as the tensor core reads them: the low 13 mantissa
    bits dropped (truncation)."""
    return (np.ascontiguousarray(a, np.float32).view(np.int32) & ~0x1FFF).view(np.float32)


def _key(v):
    """Total-order keys of float32 values with NaN canonical (largest)."""
    b = np.where(np.isnan(v), np.float32(np.nan), v).astype(np.float32).view(np.int32)
    b = np.where(np.isnan(v), 0x7FC00000, b)
    return np.where(b < 0, b ^ 0x7FFFFFFF, b)


def emulate(q, docs, mask=None, cut: float = 1.0):
    """The kernel's selection: ``(scores (B, N) float32, every best kept)``.
    Exact dots are the plain version's (float32 matmul of one document)."""
    n_b, tq, d = q.shape
    flat = q.reshape(n_b * tq, d)
    kq = tmk.maxsim_query_terms(torch.from_numpy(q)).numpy()
    m_abs = np.float32(tmk.maxsim_margin(d).abs)
    q_hi = _tf32(flat).astype(np.float64)
    acc_err = 2 * (d + 8) * 2.0**-23 * (1 + 2.0**-8)
    best = np.full((n_b * tq, docs.shape[0]), -np.inf, np.float32)
    kept = True
    for n in range(docs.shape[0]):
        x = docs[n] if mask is None else docs[n][mask[n]]
        if x.shape[0] == 0:
            continue
        with np.errstate(all="ignore"):
            exact = (torch.from_numpy(flat) @ torch.from_numpy(x).T).numpy() + np.float32(0.0)
            x_hi = _tf32(x).astype(np.float64)
            approx = q_hi @ x_hi.T
            p = np.abs(q_hi) @ np.abs(x_hi).T
            ek = _key(exact)
            top = ek == ek.max(axis=1, keepdims=True)
            st = (approx + np.where(top, -acc_err * p, acc_err * p)).astype(np.float32)
            s2 = (x * x).sum(axis=1, dtype=np.float32)
            xn = np.where(s2 < np.float32(2.0**100), np.sqrt(s2) + np.float32(2.0**-59),
                          np.float32(np.inf)).astype(np.float32)
            lim = np.full(n_b * tq, -np.inf, np.float32)
            cand = np.zeros(exact.shape, bool)
            for c0 in range(0, x.shape[0], CHUNK):
                c1 = min(x.shape[0], c0 + CHUNK)
                t = ((kq * xn[c0:c1].max() + m_abs) / np.float32(cut)).astype(np.float32)
                chunk = st[:, c0:c1]
                hi = np.where(np.isnan(chunk), -np.inf, chunk).max(axis=1)
                lo = (hi - t).astype(np.float32)
                lim = np.where(np.isnan(lo), lim, np.maximum(lim, lo))
                cand[:, c0:c1] = ~((chunk + t[:, None]).astype(np.float32) < lim[:, None])
        picked = np.where(cand, ek, np.iinfo(np.int32).min).max(axis=1)
        kept &= bool((picked == ek.max(axis=1)).all())
        pk = np.where(picked < 0, picked ^ 0x7FFFFFFF, picked).astype(np.int32)
        best[:, n] = np.where(cand.any(axis=1), pk.view(np.float32), -np.inf)
    best = np.where(best == -np.inf, np.float32(0.0), best).reshape(n_b, tq, -1)
    scores = np.zeros((n_b, docs.shape[0]), np.float32)
    with np.errstate(all="ignore"):
        for i in range(tq):
            scores = (scores + best[:, i]).astype(np.float32)
    return scores, kept


def odd_tokens(rng, n, td, d, n_b, tq):
    """Odd integers 2049-4095 in magnitude (TF32 drops the low bit); token
    1 of each document copies token 0 with coordinate 0 one nearer zero
    (TF32 dots tie, exact dots differ by q[0]); queries with two nonzero
    coordinates in [-3, 3], coordinate 0 among them."""
    docs = ((2 * rng.integers(1024, 2048, (n, td, d)) + 1)
            * rng.choice([-1, 1], (n, td, d))).astype(np.float32)
    docs[:, 1] = docs[:, 0]
    docs[:, 1, 0] -= np.sign(docs[:, 0, 0])
    q = np.zeros((n_b, tq, d), np.float32)
    q[..., 0] = rng.integers(1, 4, (n_b, tq)) * rng.choice([-1, 1], (n_b, tq))
    other = rng.integers(1, d, (n_b, tq)) if d > 1 else np.zeros((n_b, tq), int)
    np.put_along_axis(q, other[..., None], rng.integers(-3, 4, (n_b, tq, 1)).astype(np.float32),
                      axis=2)
    return q, docs


def lowbit_tokens(rng, shape):
    """Every low mantissa bit set: the largest TF32 truncations."""
    v = 1.0 + 2.0**-10 * rng.integers(0, 1024, shape) + (2.0**-10 - 2.0**-23)
    return (v * 2.0 ** rng.integers(-3, 4, shape) * rng.choice([-1, 1], shape)).astype(np.float32)


def ragged(rng, n, td):
    m = np.arange(td)[None, :] < rng.integers(2, td + 1, (n, 1))
    m[4] = False  # a fully masked document
    return m


def plain(q, docs, mask=None):
    return tmk.maxsim_scores_plain(torch.from_numpy(q), torch.from_numpy(docs),
                                   None if mask is None else torch.from_numpy(mask)).numpy()


def assert_bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(got[fin].view(np.int32), want[fin].view(np.int32))


class TestCandidates:
    @pytest.mark.parametrize("d", [1, 20, 128, 130])
    @pytest.mark.parametrize("masked", [False, True])
    def test_odd_integer_near_ties(self, rng, d, masked):
        q, docs = odd_tokens(rng, 40, 150, d, 3, 7)
        docs[3, 5, 0] = np.nan
        docs[6, 0, 0] = np.inf
        docs[9, 2, 0] = -np.inf
        q[1, 0, 0] = np.inf  # every pair of that query token re-scored
        mask = ragged(rng, 40, 150) if masked else None
        got, kept = emulate(q, docs, mask)
        assert kept
        assert_bits_equal(got, plain(q, docs, mask))

    @pytest.mark.parametrize("d", [7, 128])
    def test_lowbit_tokens(self, rng, d):
        docs = lowbit_tokens(rng, (30, 90, d))
        q = lowbit_tokens(rng, (2, 5, d))
        docs[:, 1] = _tf32(docs[:, 0])  # a TF32-exact twin a hair below
        mask = ragged(rng, 30, 90)
        got, kept = emulate(q, docs, mask)
        assert kept
        np.testing.assert_allclose(got, plain(q, docs, mask), rtol=1e-5)

    def test_gaussian_with_nonfinite_tokens(self, rng):
        docs = rng.standard_normal((50, 70, 16)).astype(np.float32)
        q = rng.standard_normal((2, 9, 16)).astype(np.float32)
        docs[2, 3] = np.nan
        docs[5, 0, 1] = np.inf
        docs[8, :, 2] = -np.inf
        _, kept = emulate(q, docs, ragged(rng, 50, 70))
        assert kept

    def test_a_cut_margin_loses_bests(self, rng):
        """A query token equal to a token whose every low mantissa bit is
        set, and that token's TF32 truncation (exact in TF32, a hair
        smaller): at D = 4096 the pushed accumulation error exceeds an
        eighth of the margin."""
        d = 4096
        x_b = np.abs(lowbit_tokens(rng, (d,)))
        docs = np.stack([_tf32(x_b), x_b])[None]
        q = x_b[None, None]
        assert emulate(q, docs)[1]
        assert not emulate(q, docs, cut=8.0)[1]


class TestAgainstJax:
    @pytest.mark.parametrize("n_b,tq,td,d,masked", [(1, 5, 12, 16, True), (3, 4, 9, 20, False),
                                                    (2, 33, 6, 8, True)])
    def test_integer_tokens_exact(self, rng, n_b, tq, td, d, masked):
        q, docs = odd_tokens(rng, 60, td, d, n_b, tq)
        mask = ragged(rng, 60, td) if masked else None
        got, kept = emulate(q, docs, mask)
        want = np.asarray(jmk.fused_maxsim_scores_batch(
            jnp.asarray(q), jnp.asarray(docs), None if mask is None else jnp.asarray(mask)))
        assert kept
        assert_bits_equal(got, want)

    def test_gaussian_within_cond_tol(self, rng):
        docs = rng.standard_normal((60, 10, 16)).astype(np.float32)
        q = rng.standard_normal((2, 6, 16)).astype(np.float32)
        mask = ragged(rng, 60, 10)
        got, kept = emulate(q, docs, mask)
        want = np.asarray(jmk.fused_maxsim_scores_batch(jnp.asarray(q), jnp.asarray(docs),
                                                        jnp.asarray(mask)))
        pair = np.einsum("btd,nsd->bnts", np.abs(q).astype(np.float64),
                         np.abs(docs).astype(np.float64))
        pair = np.where(mask[None, :, None, :], pair, 0.0)
        tol = 32 * EPS * pair.max(axis=3).sum(axis=2)
        assert kept
        np.testing.assert_allclose(got, want, rtol=0, atol=tol.max())


class TestMargin:
    def test_value_at_colbert_width(self):
        m = tmk.maxsim_margin(128)
        eta = 2 * 2.0**-10 + 2.0**-20 + 2 * 136 * 2.0**-23 * (1 + 2.0**-8)
        gamma = 128 * 2.0**-24 / (1 - 128 * 2.0**-24)
        assert m.kappa == pytest.approx(2 * (eta + gamma + 4 * 2.0**-24 * (1 + eta)), rel=1e-12)
        assert 0.0039 < m.kappa < 0.0041
        assert m.abs == 2 * 128 * 2.0**-74

    def test_grows_with_d(self):
        kappas = [tmk.maxsim_margin(d).kappa for d in (1, 8, 128, 1024, 4096)]
        assert kappas == sorted(kappas) and kappas[0] > 2 * 2.0**-10

    def test_huge_d_admits_everything(self):
        m = tmk.maxsim_margin(2**24)
        assert m.kappa == float("inf") and m.abs == float("inf")

    def test_query_terms(self):
        q = torch.tensor([[[3.0, 4.0], [np.nan, 0.0]], [[np.inf, 1.0], [2.0**51, 0.0]]])
        kq = tmk.maxsim_query_terms(q)
        assert kq.shape == (4,) and kq.dtype == torch.float32
        assert float(kq[0]) == pytest.approx(tmk.maxsim_margin(2).kappa * 5.0, rel=1e-6)
        assert torch.isinf(kq[1:]).all()

    def test_rescore_stats_before_any_launch(self, monkeypatch):
        monkeypatch.setattr(tmk, "_LAST_RESCORED", None)
        assert tmk.maxsim_rescore_stats() is None
