"""innr_tpu_torch.kernels.maxsim_kernel against innr_tpu's Pallas MaxSim kernels.

The same numpy tokens go through the JAX kernels (``fused_maxsim_scores``,
K11, and ``fused_maxsim_scores_batch``, K12, in interpret mode on the CPU)
and the port, which runs the plain version of its CUDA kernel on CPU
tensors. Integer-valued tokens: every dot and sum is exact in any order, so
scores are equal bit for bit; Gaussian tokens: within cond_tol, 32 eps of
the largest sum of |products| a score holds. Sizes stay small (N <= 300,
Td <= 12, D <= 32) so that interpret mode stays fast. inf * 0 is kept out
of compared scores (the CPU makes a negative NaN there, which the JAX
package ranks last and the port, canonical, first).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from innr_tpu.kernels import maxsim_kernel as jmk  # noqa: E402
from innr_tpu.ops.maxsim import batch_maxsim as jax_batch_maxsim  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import maxsim_kernel as tmk  # noqa: E402
from innr_tpu_torch.kernels.row_scan import SMEM_LIMIT  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch.utils.padding import round_up  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


EPS = float(np.finfo(np.float32).eps)


def int_tokens(rng, shape, lo=-3, hi=3):
    return rng.integers(lo, hi + 1, shape).astype(np.float32)


def ragged_mask(rng, n, td):
    """Valid prefixes of random lengths in [1, td]; document 2 fully masked."""
    mask = np.arange(td)[None, :] < rng.integers(1, td + 1, (n, 1))
    mask[2] = False
    return mask


def port_batch(q, docs, mask=None):
    return tmk.fused_maxsim_scores_batch(
        torch.from_numpy(q), torch.from_numpy(docs),
        None if mask is None else torch.from_numpy(mask)).numpy()


def jax_batch(q, docs, mask=None):
    return np.asarray(jmk.fused_maxsim_scores_batch(
        jnp.asarray(q), jnp.asarray(docs), None if mask is None else jnp.asarray(mask)))


def jax_single(q, docs, mask=None):
    return np.asarray(jmk.fused_maxsim_scores(
        jnp.asarray(q), jnp.asarray(docs), None if mask is None else jnp.asarray(mask)))


def cond_tol(q, docs, mask=None):
    """(B, N) float64: 32 eps sum_i max_j sum_d |q_id d_jd| (valid j)."""
    pair = np.einsum("btd,nsd->bnts", np.abs(q).astype(np.float64), np.abs(docs).astype(np.float64))
    if mask is not None:
        pair = np.where(mask[None, :, None, :], pair, 0.0)
    return 32 * EPS * pair.max(axis=3).sum(axis=2)


def assert_bits_equal(got, want):
    """Scores bit for bit, any NaN as one NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(got[fin].view(np.int32), want[fin].view(np.int32))


class TestScoresAgainstJax:
    @pytest.mark.parametrize("n_b,tq,td,d,masked", [
        (1, 1, 1, 1, False),
        (1, 7, 5, 8, True),
        (3, 4, 12, 32, True),
        (2, 9, 3, 17, False),
        (4, 33, 6, 16, True),
    ])
    def test_integer_valued_exact(self, rng, n_b, tq, td, d, masked):
        n = 300
        q = int_tokens(rng, (n_b, tq, d))
        docs = int_tokens(rng, (n, td, d), -4, 4)
        mask = ragged_mask(rng, n, td) if masked else None
        got = port_batch(q, docs, mask)
        assert got.shape == (n_b, n) and got.dtype == np.float32
        assert_bits_equal(got, jax_batch(q, docs, mask))
        for b in range(n_b):
            assert_bits_equal(got[b], jax_single(q[b], docs, mask))

    def test_single_query_entry(self, rng):
        q = int_tokens(rng, (5, 16))
        docs = int_tokens(rng, (200, 7, 16), -4, 4)
        mask = ragged_mask(rng, 200, 7)
        got = tmk.fused_maxsim_scores(torch.from_numpy(q), torch.from_numpy(docs),
                                      torch.from_numpy(mask))
        assert got.shape == (200,)
        assert_bits_equal(got.numpy(), jax_single(q, docs, mask))

    @pytest.mark.parametrize("masked", [False, True])
    def test_gaussian_within_cond_tol(self, rng, masked):
        q = rng.standard_normal((3, 6, 24)).astype(np.float32)
        docs = rng.standard_normal((250, 9, 24)).astype(np.float32)
        mask = ragged_mask(rng, 250, 9) if masked else None
        np.testing.assert_allclose(port_batch(q, docs, mask), jax_batch(q, docs, mask), rtol=0,
                                   atol=float(cond_tol(q, docs, mask).max()))

    def test_minus_inf_best_clamps_to_zero(self, rng):
        """A fully masked document and a document whose every dot is -inf
        both score 0.0; one -inf token among finite ones never wins."""
        q = np.abs(int_tokens(rng, (1, 3, 8))) + 1.0  # positive: inf * q is never inf * 0
        docs = int_tokens(rng, (150, 4, 8), -4, 4)
        docs[10, :, 0] = -np.inf   # every dot -inf
        docs[11, 0, 0] = -np.inf   # one -inf token
        mask = np.ones((150, 4), bool)
        mask[12] = False           # fully masked
        got = port_batch(q, docs, mask)
        assert_bits_equal(got, jax_batch(q, docs, mask))
        assert got[0, 10] == 0.0 and got[0, 12] == 0.0
        assert np.isfinite(got[0, 11]) and got[0, 11] == port_batch(q, docs[11:12, 1:])[0, 0]

    def test_nan_and_inf_propagate(self, rng):
        q = np.abs(int_tokens(rng, (4, 8))) + 1.0
        docs = int_tokens(rng, (160, 5, 8), -4, 4)
        docs[3, 2, 1] = np.nan
        docs[7, 0, 0] = np.inf
        mask = np.ones((160, 5), bool)
        mask[8, 1] = False
        docs[8, 1, 0] = np.nan  # masked: must not reach the score
        got = port_batch(q[None], docs, mask)[0]
        assert np.isnan(got[3]) and got[7] == np.inf and np.isfinite(got[8])
        assert_bits_equal(got, jax_single(q, docs, mask))

    @pytest.mark.parametrize("integer", [True, False])
    def test_bf16_docs_match_jax_bf16_path(self, rng, integer):
        """bf16 documents: the query rounded to bf16, float32 accumulation."""
        q = int_tokens(rng, (2, 5, 16)) if integer else rng.standard_normal((2, 5, 16))
        docs = int_tokens(rng, (200, 6, 16), -4, 4) if integer else rng.standard_normal(
            (200, 6, 16))
        q, docs = q.astype(np.float32), docs.astype(np.float32)
        mask = ragged_mask(rng, 200, 6)
        got = tmk.fused_maxsim_scores_batch(torch.from_numpy(q),
                                            torch.from_numpy(docs).to(torch.bfloat16),
                                            torch.from_numpy(mask)).numpy()
        want = np.asarray(jmk.fused_maxsim_scores_batch(
            jnp.asarray(q), jnp.asarray(docs).astype(jnp.bfloat16), jnp.asarray(mask)))
        if integer:
            assert_bits_equal(got, want)
        else:
            q16 = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
            d16 = np.asarray(jnp.asarray(docs).astype(jnp.bfloat16).astype(jnp.float32))
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=float(cond_tol(q16, d16, mask).max()))

    def test_r7_each_query_on_its_own(self, rng):
        """ROADMAP R7: an inf in query 1 turns JAX's K12 scores of queries 0
        and 2 into NaN (its group-indicator matmul, 0 * inf); the port
        scores each query alone and equals batch_maxsim and K11 there."""
        q = rng.standard_normal((3, 4, 8)).astype(np.float32)
        docs = rng.standard_normal((16, 5, 8)).astype(np.float32)
        q[1, 0, 0] = np.inf
        got = port_batch(q, docs)
        want = np.asarray(jax_batch_maxsim(jnp.asarray(q), jnp.asarray(docs)))
        # Query 1 scores +inf where some doc token has d[0] > 0; there JAX's
        # K12 gives NaN for queries 0 and 2 too (the reference fault).
        hit = want[1] == np.inf
        assert hit.any() and np.isnan(jax_batch(q, docs)[[0, 2]][:, hit]).all()
        tol = float(cond_tol(q[[0, 2]], docs).max())
        for b in (0, 2):
            assert np.isfinite(got[b]).all()
            np.testing.assert_allclose(got[b], want[b], rtol=0, atol=tol)
            np.testing.assert_allclose(got[b], jax_single(q[b], docs), rtol=0, atol=tol)
        # Query 1 as K11 scores it alone: +inf where hit, else its -inf
        # best clamped to 0 (batch_maxsim without a mask keeps the -inf).
        assert (got[1][hit] == np.inf).all() and np.isfinite(got[1][~hit]).all()
        np.testing.assert_allclose(got[1], jax_single(q[1], docs), rtol=0, atol=tol)

    def test_finite_batch_equals_jax_k12(self, rng):
        q = int_tokens(rng, (5, 3, 12))
        docs = int_tokens(rng, (130, 4, 12), -4, 4)
        assert_bits_equal(port_batch(q, docs), jax_batch(q, docs))

    def test_zero_padded_query_tokens(self, rng):
        """A batch shares one Tq: zero tokens add max(0, ...) = 0 only where
        some valid dot is >= 0, as in the JAX package (R3)."""
        q = int_tokens(rng, (2, 6, 8))
        q[1, 3:] = 0.0
        docs = int_tokens(rng, (140, 5, 8), -4, 4)
        assert_bits_equal(port_batch(q, docs), jax_batch(q, docs))

    @pytest.mark.parametrize("shape", [((2, 0, 8), (9, 4, 8)), ((2, 3, 8), (0, 4, 8)),
                                       ((2, 3, 8), (9, 0, 8)), ((0, 3, 8), (9, 4, 8)),
                                       ((2, 3, 0), (9, 4, 0))])
    def test_empty_dims_score_zero(self, shape):
        qs, ds = shape
        got = tmk.fused_maxsim_scores_batch(torch.ones(qs), torch.ones(ds))
        assert tuple(got.shape) == (qs[0], ds[0]) and (got == 0).all()


class TestSelection:
    def test_knn_matches_jax_with_ties(self, rng):
        q = int_tokens(rng, (3, 4, 8))
        docs = int_tokens(rng, (180, 5, 8), -4, 4)
        docs[[40, 90, 170]] = docs[7]
        docs[11, 0, 0] = np.nan
        mask = ragged_mask(rng, 180, 5)
        mask[[40, 90, 170]] = mask[7]
        k = 180  # every document: the tied ones are all ranked
        gv, gi = tmk.fused_maxsim_knn_batch(torch.from_numpy(q), torch.from_numpy(docs), k,
                                            torch.from_numpy(mask))
        jv, ji = jmk.fused_maxsim_knn_batch(jnp.asarray(q), jnp.asarray(docs), k,
                                            jnp.asarray(mask))
        assert gi.dtype == torch.int32 and gv.dtype == torch.float32
        assert_bits_equal(gv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
        assert (gi[:, 0] == 11).all()  # NaN first
        for b in range(3):
            pos = [int(np.flatnonzero(gi[b].numpy() == j)[0]) for j in (7, 40, 90, 170)]
            assert pos == sorted(pos)  # equal scores: the lowest document first
        one_v, one_i = tmk.fused_maxsim_knn(torch.from_numpy(q[0]), torch.from_numpy(docs), 12,
                                            torch.from_numpy(mask))
        assert torch.equal(one_i, gi[0, :12])
        assert torch.equal(one_v.view(torch.int32), gv[0, :12].view(torch.int32))


class TestPlainVersion:
    def test_chunks_do_not_change_bits(self, rng, monkeypatch):
        q = rng.standard_normal((3, 5, 16)).astype(np.float32)
        docs = rng.standard_normal((70, 6, 16)).astype(np.float32)
        mask = ragged_mask(rng, 70, 6)
        args = (torch.from_numpy(q), torch.from_numpy(docs), torch.from_numpy(mask))
        whole = tmk.maxsim_scores_plain(*args)
        monkeypatch.setattr(tmk, "_PLAIN_PAIRS", 1)  # one document per chunk
        assert torch.equal(tmk.maxsim_scores_plain(*args).view(torch.int32),
                           whole.view(torch.int32))

    def test_nan_canonical_and_zero_positive(self):
        q = torch.tensor([[[1.0, -1.0]]])
        docs = torch.tensor([[[float("nan"), 0.0]], [[0.0, 0.0]], [[-0.0, 0.0]]])
        got = tmk.maxsim_scores_plain(q, docs)
        assert got.view(torch.int32).tolist() == [[0x7FC00000, 0, 0]]

    @pytest.mark.parametrize("n_b,tq,d", [(1, 1, 1), (1, 32, 128), (16, 32, 128), (17, 7, 96),
                                           (3, 33, 130), (1, 200, 128), (2, 129, 64)])
    def test_tiling_fits_and_holds_whole_queries(self, n_b, tq, d):
        for td in (1, 180, 5000):
            qpt, mt, tpw, ts, seg, ctas, kb = tmk._tiling(n_b, tq, td, d)
            assert 1 <= qpt <= n_b and qpt * tq <= mt and mt % 64 == 0 and mt <= max(256, tq + 63)
            assert tpw in (1, 2) and kb % 8 == 0 and ts % 8 == 0
            assert 8 <= ts <= round_up(seg, 8) and seg == min(td, 1024)
            assert ts < 64 or ts % 64 == 0 or ts == round_up(seg, 8)
            assert ctas in (1, 2) and (ctas == 1 or (tpw == 1 and kb == 0))
            assert tmk._f32_smem(mt, ts, d, tpw, kb, seg) <= SMEM_LIMIT // ctas

    def test_tiling_b16_reads_the_corpus_four_times(self):
        """Named for the FMA kernel's four reads; the tensor-core kernel
        holds 256 query tokens, so B = 16 at Tq = 32 is two tiles: two
        corpus reads, items of one 64-token chunk; Q = 1 is one row tile,
        two CTAs per SM."""
        qpt, mt, tpw, ts, seg, ctas, kb = tmk._tiling(16, 32, 180, 128)
        assert (qpt, mt, tpw, ts, seg, ctas, kb) == (8, 256, 2, 64, 180, 1, 0)
        assert -(-16 // qpt) == 2
        assert tmk._tiling(1, 32, 180, 128)[2:6] == (1, 64, 180, 2)

    def test_tiling_raises_when_nothing_fits(self):
        with pytest.raises(ContractError, match="shared memory"):
            tmk._tiling(1, 1, 8, 200_000)

    def test_tiling_stages_a_wide_tile_per_block(self):
        """D = 1024 leaves no room for a resident tile: it is staged per
        pass in blocks of 128 dimensions."""
        assert tmk._tiling(1, 32, 60, 1024)[6] == 128
        assert tmk._tiling(1, 32, 180, 128)[6] == 0

    @pytest.mark.parametrize("n_b,tq,td,d", [(1, 1, 1, 1), (16, 32, 180, 128), (17, 33, 180, 130),
                                             (1, 33, 5, 96), (17, 1, 180, 128), (2, 300, 12, 64),
                                             (16, 32, 2048, 128), (1, 32, 180, 1024),
                                             (2, 700, 9, 16), (16, 32, 180, 1440)])
    def test_bf16_tiling_fits_and_holds_whole_queries(self, n_b, tq, td, d):
        qpt, tt, tpw, ts = tmk._tiling_bf16(n_b, tq, td, d)
        assert 1 <= qpt <= n_b and qpt * tq <= tt and tt % 64 == 0
        assert tpw in (1, 2, 4) and (tt <= 2 * 64 * tpw <= 2 * tt + 64 * 2 or tpw == 4)
        assert ts % 8 == 0 and 8 <= ts <= round_up(td, 8)
        n_seg = -(-td // ts)
        assert n_seg == 1 or (n_seg - 1) * ts < td  # equal segments, none empty
        assert tmk._bf16_smem(tt, ts, d) <= SMEM_LIMIT

    def test_bf16_tiling_holds_the_b16_batch(self):
        """ColBERTv2 widths at B = 16: one tile of all 512 query tokens and
        whole documents, so the corpus is read once per batch."""
        assert tmk._tiling_bf16(16, 32, 180, 128) == (16, 512, 4, 184)

    @pytest.mark.parametrize("td,n_seg,ts", [(300, 2, 152), (2048, 12, 176), (8192, 45, 184)])
    def test_bf16_tiling_cuts_long_documents_into_segments(self, td, n_seg, ts):
        """Documents longer than fits beside the B = 16 tile run in equal
        segments: the batch stays one tile (one corpus read) at any Td."""
        assert tmk._tiling_bf16(16, 32, td, 128) == (16, 512, 4, ts)
        assert -(-td // ts) == n_seg

    def test_bf16_tiling_scores_a_long_query_in_passes(self):
        qpt, tt, tpw, _ = tmk._tiling_bf16(3, 700, 9, 16)
        assert (qpt, tt, tpw) == (1, 704, 4)  # 11 row tiles: two passes of 8

    def test_bf16_tiling_raises_when_one_query_does_not_fit(self):
        with pytest.raises(ContractError, match="shared memory"):
            tmk._tiling_bf16(1, 7000, 8, 16)
        with pytest.raises(ContractError, match="shared memory"):
            tmk._tiling_bf16(1, 1, 180, 4096)


class TestDispatchAndContracts:
    def _args(self, rng):
        return (torch.from_numpy(int_tokens(rng, (2, 3, 8))),
                torch.from_numpy(int_tokens(rng, (50, 4, 8))))

    def test_force_reference_runs_plain(self, rng, monkeypatch):
        q, docs = self._args(rng)
        want = tmk.maxsim_scores_plain(q, docs)
        monkeypatch.setattr(config, "_FORCE_REFERENCE", True)
        before = tmk.LAUNCHES
        assert torch.equal(tmk.fused_maxsim_scores_batch(q, docs), want)
        assert tmk.LAUNCHES == before

    def test_meta_device_raises_not_falls_back(self):
        with pytest.raises(ContractError, match="unsupported device"):
            tmk.fused_maxsim_scores_batch(torch.ones(1, 2, 4, device="meta"),
                                          torch.ones(3, 5, 4, device="meta"))

    @pytest.mark.parametrize("bad", [
        dict(q=torch.ones(3, 8)),
        dict(docs=torch.ones(50, 8)),
        dict(docs=torch.ones(50, 4, 7)),
        dict(mask=torch.ones(50, 5, dtype=torch.bool)),
        dict(mask=torch.ones(4, 50, dtype=torch.bool)),
    ])
    def test_shapes_raise(self, rng, bad):
        q, docs = self._args(rng)
        args = dict(q=q, docs=docs, mask=None)
        args.update(bad)
        with pytest.raises(ContractError):
            tmk.fused_maxsim_scores_batch(args["q"], args["docs"], args["mask"])

    def test_single_query_must_be_2d(self, rng):
        q, docs = self._args(rng)
        with pytest.raises(ContractError):
            tmk.fused_maxsim_scores(q, docs)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestKernelOnCuda:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n_b,tq,td,d", [(1, 1, 1, 1), (1, 32, 180, 128), (16, 32, 5, 96),
                                             (17, 33, 12, 130), (2, 200, 7, 64)])
    def test_kernel_matches_plain_exactly(self, cuda_device, dtype, n_b, tq, td, d):
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        q = torch.randint(-3, 4, (n_b, tq, d), generator=gen, device=cuda_device).float()
        docs = torch.randint(-4, 5, (3077, td, d), generator=gen, device=cuda_device).float()
        docs[3, 0, 0] = float("nan")
        docs = docs.to(getattr(torch, dtype))
        mask = torch.rand((3077, td), generator=gen, device=cuda_device) < 0.7
        before = tmk.LAUNCHES
        got = tmk.fused_maxsim_scores_batch(q, docs, mask)
        assert tmk.LAUNCHES == before + 1
        want = tmk.maxsim_scores_plain(q, docs, mask)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    @pytest.mark.parametrize("d", [1, 96, 130])
    @pytest.mark.parametrize("tq", [1, 33])
    @pytest.mark.parametrize("n_b", [1, 17])
    def test_bf16_tensor_core_padding(self, cuda_device, d, tq, n_b):
        """The wgmma kernel pads D to 16, query tiles to 64 and the last
        document chunk to 64 tokens: integer tokens, exact in any order."""
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        q = torch.randint(-3, 4, (n_b, tq, d), generator=gen, device=cuda_device).float()
        docs = torch.randint(-4, 5, (1037, 70, d), generator=gen, device=cuda_device)
        docs = docs.to(torch.bfloat16)
        mask = torch.rand((1037, 70), generator=gen, device=cuda_device) < 0.97
        mask[5] = False  # no valid token: 0.0
        before = tmk.LAUNCHES_BY_DTYPE["bfloat16"]
        got = tmk.fused_maxsim_scores_batch(q, docs, mask)
        assert tmk.LAUNCHES_BY_DTYPE["bfloat16"] == before + 1
        want = tmk.maxsim_scores_plain(q, docs, mask)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert (got[:, 5] == 0).all()

    @pytest.mark.parametrize("n_b,tq,td,d", [(16, 32, 700, 128), (1, 32, 60, 1024),
                                             (2, 700, 9, 16)])
    def test_bf16_segments_and_passes(self, cuda_device, n_b, tq, td, d):
        """Documents in several segments (a NaN and the only valid tokens
        in late ones) and a query scored in two passes of row tiles."""
        assert -(-td // tmk._tiling_bf16(n_b, tq, td, d)[3]) > 1 or tq > 512
        gen = torch.Generator(device=cuda_device).manual_seed(8)
        q = torch.randint(-3, 4, (n_b, tq, d), generator=gen, device=cuda_device).float()
        docs = torch.randint(-4, 5, (300, td, d), generator=gen, device=cuda_device).float()
        docs[3, td - 1, 0] = float("nan")
        docs = docs.to(torch.bfloat16)
        mask = torch.rand((300, td), generator=gen, device=cuda_device) < 0.9
        mask[7, : td - 2] = False  # valid tokens only in the last segment
        mask[3, td - 1] = True
        got = tmk.fused_maxsim_scores_batch(q, docs, mask)
        want = tmk.maxsim_scores_plain(q, docs, mask)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.isnan(got[:, 3]).all()

    def test_r7_rows_equal_single_launches(self, cuda_device):
        gen = torch.Generator(device=cuda_device).manual_seed(6)
        q = torch.randn((3, 4, 8), generator=gen, device=cuda_device)
        docs = torch.randn((1000, 5, 8), generator=gen, device=cuda_device)
        q[1, 0, 0] = float("inf")
        got = tmk.fused_maxsim_scores_batch(q, docs)
        for b in range(3):
            one = tmk.fused_maxsim_scores(q[b], docs)
            assert torch.equal(got[b].view(torch.int32), one.view(torch.int32))
        assert torch.isfinite(got[[0, 2]]).all()
