"""The sharded families of innr_tpu_torch.parallel against innr_tpu.parallel:
u8, packed binary / ternary, slot sketches, sparse, sparse MaxSim, MaxSim
and the two-stage index.

The JAX side runs on its 8 virtual CPU devices, the port on a mesh of
``["cpu"] * 8`` (the same shard count); both get the same numpy draws.
Integer counts, integer-valued data and packed words drawn over all 32 bits
(the sign bit of the int32 view included) must give equal indices and
scores bit for bit, ties across shards to the lowest global index. The u8
scores meet the affine map's float32 constants in an order of their own, so
they are held bit for bit to the port's single-device call and within
``cond_tol`` to JAX. The ``cuda`` class holds a 4 x ``cuda:0`` mesh to the
single-card calls on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu.parallel as jp  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
import innr_tpu_torch.parallel as tp  # noqa: E402
from conftest import cond_tol  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.ops.binary import binary_knn_batch  # noqa: E402
from innr_tpu_torch.utils.bits import unsigned_to_numpy  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def cpu_mesh(n=8):
    return tp.default_mesh(["cpu"] * n)


def int_rows(rng, n, d, lo=-3, hi=4):
    return rng.integers(lo, hi, (n, d)).astype(np.float32)


def np_(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same(got, want):
    """Port results against JAX (or port) results: float bits (NaN as one
    NaN) or integers, exactly."""
    for g, w in zip(got, want, strict=True):
        g, w = np_(g), np_(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype == np.float32:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_array_equal(g[~np.isnan(w)].view(np.int32),
                                          w[~np.isnan(w)].view(np.int32))
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


class TestShardedU8:
    def test_integer_queries_equal_jax_and_the_single_device_call(self, rng):
        rows = rng.standard_normal((400, 32)).astype(np.float32)
        qs = int_rows(rng, 3, 32)
        params = tt.QuantizationParams(**vars(it.QuantizationParams.fit(rows)))
        sq = tp.ShardedQuantizedU8.quantize(rows, params, cpu_mesh())
        got = sq.knn(qs, 6)
        jparams = it.QuantizationParams.fit(rows)
        want = jp.ShardedQuantizedU8.quantize(rows, jparams).knn(qs, 6)
        np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
        tol = max(cond_tol(q, np.full(32, 255.0)) for q in qs) * params.alpha / 255 + 1e-5
        np.testing.assert_allclose(np_(got[0]), np.asarray(want[0]), rtol=0, atol=tol)
        single = tt.batch_knn_u8_multi(qs, tt.QuantizedU8Batch.quantize(rows, params),
                                       params, 6)
        same(got, single)
        codes = np.concatenate([np_(c) for c in sq.shards])
        np.testing.assert_array_equal(codes, np.asarray(it.QuantizedU8Batch.quantize(
            rows, jparams).codes))

    def test_fit_when_no_params_and_single_query(self, rng):
        rows = rng.standard_normal((90, 16)).astype(np.float32)
        sq = tp.ShardedQuantizedU8.quantize(rows, mesh=cpu_mesh())
        jq = jp.ShardedQuantizedU8.quantize(rows)
        assert (sq.params.alpha, sq.params.offset) == (jq.params.alpha, jq.params.offset)
        q = int_rows(rng, 1, 16)[0]
        v, i = sq.knn(q, 4)
        assert np_(i).shape == (4,)
        np.testing.assert_array_equal(np_(i), np.asarray(jq.knn(q, 4)[1]))
        assert sq.memory_bytes() == 90 * 16

    def test_from_code_source_memmap(self, rng, tmp_path):
        rows = rng.standard_normal((180, 48)).astype(np.float32)
        params = tt.QuantizationParams.fit(rows)
        codes = np_(tt.QuantizedU8Batch.quantize(rows, params).codes)
        codes.tofile(tmp_path / "codes.bin")
        mm = np.memmap(tmp_path / "codes.bin", dtype=np.uint8, mode="r", shape=codes.shape)
        streamed = tp.ShardedQuantizedU8.from_code_source(lambda a, b: mm[a:b], params, 180,
                                                          48, cpu_mesh())
        full = tp.ShardedQuantizedU8(codes, params, cpu_mesh())
        qs = int_rows(rng, 3, 48)
        same(streamed.knn(qs, 5), full.knn(qs, 5))

    def test_edges(self, rng):
        rows = rng.standard_normal((6, 8)).astype(np.float32)
        sq = tp.ShardedQuantizedU8.quantize(rows, mesh=cpu_mesh())
        assert np_(sq.knn(rows[:3], 0)[0]).shape == (3, 0)
        assert np_(sq.knn(rows[0], 99)[1]).shape == (6,)
        with pytest.raises(tt.ContractError):
            sq.knn(np.zeros(5, np.float32), 2)


class TestShardedPacked:
    @pytest.mark.parametrize("d", [8, 70])
    def test_binary_equals_jax(self, rng, d):
        rows = rng.standard_normal((301, d)).astype(np.float32)
        sb = tp.ShardedPackedBinary.encode(rows, 0.0, cpu_mesh())
        jb = jp.ShardedPackedBinary.encode(rows, 0.0)
        q_words = np.asarray(it.encode_binary_batch(rows[:5], 0.0))
        for k in (1, 10, 301):
            got = sb.knn_batch(q_words, k)
            same(got, tuple(np.asarray(a).astype(np.int64) for a in jb.knn_batch(q_words, k)))
        got = sb.knn(tt.encode_binary(rows[9], 0.0), 4)
        want = jb.knn(it.encode_binary(rows[9], 0.0), 4)
        same(got, tuple(np.asarray(a).astype(np.int64) for a in want))
        assert int(np_(got[1])[0]) == 9 or int(np_(got[0])[0]) == 0

    def test_binary_words_over_all_32_bits_and_ties(self, rng):
        words = rng.integers(0, 2**32, (200, 2), dtype=np.uint64).astype(np.uint32)
        words[[3, 60, 130]] = words[100]
        sb = tp.ShardedPackedBinary(words, 64, cpu_mesh())
        jb = jp.ShardedPackedBinary(words, 64)
        got = sb.knn_batch(words[[100, 7]], 12)
        want = jb.knn_batch(words[[100, 7]], 12)
        same(got, tuple(np.asarray(a).astype(np.int64) for a in want))
        assert list(np_(got[1])[0, :4]) == [3, 60, 100, 130]

    def test_k_above_single_pass_k(self, rng, monkeypatch):
        monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
        rows = rng.standard_normal((250, 40)).astype(np.float32)
        q_words = np.asarray(it.encode_binary_batch(rows[:3], 0.0))
        got = tp.ShardedPackedBinary.encode(rows, 0.0, cpu_mesh()).knn_batch(q_words, 40)
        want = jp.ShardedPackedBinary.encode(rows, 0.0).knn_batch(q_words, 40)
        same(got, tuple(np.asarray(a).astype(np.int64) for a in want))

    def test_ternary_equals_jax(self, rng):
        rows = rng.standard_normal((300, 96)).astype(np.float32)
        st = tp.ShardedPackedTernary.encode(rows, 0.3, cpu_mesh())
        jt = jp.ShardedPackedTernary.encode(rows, 0.3)
        got = st.knn(tt.encode_ternary(rows[17], 0.3), 5)
        same(got, jt.knn(it.encode_ternary(rows[17], 0.3), 5))
        planes = tuple(np.asarray(p) for p in it.encode_ternary_batch(rows[:4], 0.3))
        same(st.knn_batch(planes, 7), jt.knn_batch(planes, 7))
        pos, neg = (np.asarray(p) for p in it.encode_ternary_batch(rows, 0.3))
        direct = tp.ShardedPackedTernary(pos, neg, 96, cpu_mesh())
        same(direct.knn_batch(planes, 7), jt.knn_batch(planes, 7))
        assert direct.memory_bytes() == 2 * 300 * 3 * 4

    def test_from_word_source_masks_padding_bits(self, rng):
        rows = rng.standard_normal((64, 40)).astype(np.float32)
        words = np.asarray(it.encode_binary_batch(rows, 0.0))
        dirty = words.copy()
        dirty[:, -1] |= np.uint32(0xFFFFFF00)
        calls = []
        streamed = tp.ShardedPackedBinary.from_word_source(
            lambda a, b: calls.append((a, b)) or dirty[a:b], 64, 40, cpu_mesh())
        assert calls == [(8 * i, 8 * i + 8) for i in range(8)]
        counts, idx = streamed.knn(tt.encode_binary(rows[3], 0.0), 1)
        assert int(np_(idx)[0]) == 3 and int(np_(counts)[0]) == 0
        full = tp.ShardedPackedBinary(words, 40, cpu_mesh())
        same(streamed.knn_batch(words[:5], 6), full.knn_batch(words[:5], 6))

    def test_edges(self, rng):
        rows = rng.standard_normal((6, 64)).astype(np.float32)
        sb = tp.ShardedPackedBinary.encode(rows, 0.0, cpu_mesh())
        assert np_(sb.knn(tt.encode_binary(rows[0], 0.0), 0)[0]).shape == (0,)
        st = tp.ShardedPackedTernary.encode(rows, 0.2, cpu_mesh())
        assert np_(st.knn(tt.encode_ternary(rows[0], 0.2), 99)[0]).shape == (6,)
        with pytest.raises(tt.ContractError):
            sb.knn(tt.encode_binary(rows[0, :32], 0.0), 2)
        with pytest.raises(tt.ContractError):
            tp.ShardedPackedBinary(np.zeros((4, 3), np.uint32), 64, cpu_mesh())


class TestShardedSlot:
    def test_u32_equals_jax_with_ties(self, rng):
        sk = rng.integers(0, 4, (500, 32)).astype(np.uint32)
        sk[:, 0] |= np.uint32(0x80000000)  # the top bit set
        sc = tp.ShardedSlotCorpus(sk, cpu_mesh())
        js = jp.ShardedSlotCorpus(sk)
        same(sc.knn(sk[123], 7), tuple(np.asarray(a).astype(np.int64)
                                       for a in js.knn(sk[123], 7)))
        got = sc.knn_batch(sk[[5, 250, 499]], 20)
        same(got, tuple(np.asarray(a).astype(np.int64)
                        for a in js.knn_batch(sk[[5, 250, 499]], 20)))
        np.testing.assert_array_equal(np_(got[1])[:, 0], [5, 250, 499])
        same(sc.minhash_knn(sk[5], 3), js.minhash_knn(sk[5], 3))
        single = tt.slot_knn_u32_batch(sk[[5, 250, 499]], tt.SketchCorpus(sk), 20)
        same(got, single)

    def test_u16_and_its_stream(self, rng):
        sk = rng.integers(0, 1 << 16, (600, 24)).astype(np.uint16)
        sc = tp.ShardedSlotCorpus(sk, cpu_mesh())
        assert sc.bits == 16 and sc.memory_bytes() == 600 * 24 * 2
        js = jp.ShardedSlotCorpus(sk)
        same(sc.knn_batch(sk[:3], 4), tuple(np.asarray(a).astype(np.int64)
                                            for a in js.knn_batch(sk[:3], 4)))
        streamed = tp.ShardedSlotCorpus.from_sketch_source(lambda a, b: sk[a:b], 600, 24,
                                                           cpu_mesh(), dtype=np.uint16)
        assert streamed.bits == 16
        same(streamed.knn(sk[42], 3), sc.knn(sk[42], 3))

    def test_stream_with_empty_shards_and_contracts(self, rng):
        sk = rng.integers(0, 8, (9, 16)).astype(np.uint32)
        calls = []
        sc = tp.ShardedSlotCorpus.from_sketch_source(
            lambda a, b: calls.append((a, b)) or sk[a:b], 9, 16, cpu_mesh())
        assert calls == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 9)]
        assert int(np_(sc.knn(sk[8], 3)[1])[0]) == 8
        with pytest.raises(tt.ContractError):
            sc.knn(sk[:3], 2)
        with pytest.raises(tt.ContractError):
            sc.knn_batch(sk[0], 2)
        with pytest.raises(tt.ContractError):
            sc.knn(np.zeros(17, np.uint32), 2)
        with pytest.raises(tt.ContractError):
            tp.ShardedSlotCorpus(sk.astype(np.uint32), cpu_mesh(), dtype=np.uint16)
        with pytest.raises(tt.ContractError):
            tp.ShardedSlotCorpus.from_sketch_source(
                lambda a, b: np.zeros((b - a, 99), np.uint32), 64, 24, cpu_mesh())
        assert np_(sc.knn_batch(sk[:2], 0)[0]).shape == (2, 0)


def vocabulary(rng, size=48):
    """Sorted unique uint32 ids, half of them >= 2**31."""
    ids = np.concatenate([rng.choice(2**31, size // 2, replace=False),
                          rng.choice(2**31 - 1, size // 2, replace=False) + 2**31])
    return np.unique(ids.astype(np.uint32))


def sparse_docs(rng, n, vocab, max_nnz=8):
    out = []
    for _ in range(n):
        nnz = int(rng.integers(1, max_nnz + 1))
        idx = np.sort(rng.choice(vocab, nnz, replace=False)).astype(np.uint32)
        out.append((idx, rng.integers(-4, 5, nnz).astype(np.float32)))
    return out


class TestShardedSparse:
    def test_integer_values_equal_jax(self, rng):
        vocab = vocabulary(rng)
        d = sparse_docs(rng, 333, vocab)
        sc = tp.ShardedSparseCorpus(d, cpu_mesh())
        js = jp.ShardedSparseCorpus(d)
        for k in (1, 6, 333):
            same(sc.knn(d[42], k), js.knn(d[42], k))
        qs = [d[0], d[50], d[99]]
        same(sc.knn_batch(qs, 5), js.knn_batch(qs, 5))
        same(sc.knn_batch(qs, 5), tt.sparse_knn_batch(qs, tt.SparseCorpus(d), 5))

    def test_padded_pair_and_sparse_corpus_inputs(self, rng):
        vocab = vocabulary(rng)
        d = sparse_docs(rng, 100, vocab)
        tc = tt.SparseCorpus(d)
        from_pair = tp.ShardedSparseCorpus((unsigned_to_numpy(tc.indices), tc.values.numpy()),
                                           cpu_mesh())
        from_corpus = tp.ShardedSparseCorpus(tc, cpu_mesh())
        assert from_pair.width == from_corpus.width == tc.width
        same(from_pair.knn_batch(d[:4], 7), from_corpus.knn_batch(d[:4], 7))
        assert from_corpus.memory_bytes() == tc.memory_bytes()

    def test_k_above_single_pass_and_edges(self, rng, monkeypatch):
        monkeypatch.setattr(tk, "_K_MAX_PASS", 8)
        vocab = vocabulary(rng)
        d = sparse_docs(rng, 100, vocab)
        sc = tp.ShardedSparseCorpus(d, cpu_mesh())
        same(sc.knn_batch(d[:2], 30), jp.ShardedSparseCorpus(d).knn_batch(d[:2], 30))
        assert np_(sc.knn(d[0], 0)[1]).shape == (0,)
        assert np_(sc.knn(d[0], 1000)[1]).shape == (100,)
        with pytest.raises(tt.ContractError):
            sc.knn(d[:3], 3)


class TestShardedSparseMaxSim:
    def test_integer_values_equal_jax(self, rng):
        vocab = vocabulary(rng, 64)

        def doc(nt):
            return sparse_docs(rng, nt, vocab, 6)

        docs = [doc(int(rng.integers(1, 5))) for _ in range(40)]
        sc = tp.ShardedSparseMaxSimCorpus(docs, cpu_mesh())
        js = jp.ShardedSparseMaxSimCorpus(docs)
        for qd in (21, 3):
            same(sc.knn(docs[qd], 6), js.knn(docs[qd], 6))
        same(sc.knn(docs[21], 6), tt.sparse_maxsim_knn(docs[21], docs, 6))
        same(sc.knn([], 3), js.knn([], 3))
        assert np_(sc.knn(docs[0], 0)[1]).shape == (0,)
        assert sc.num_docs == 40 and sc.memory_bytes() > 0
        padded = tt.pad_sparse_docs(docs, device="cpu")
        same(tp.ShardedSparseMaxSimCorpus(padded, cpu_mesh(3)).knn(docs[5], 4),
             js.knn(docs[5], 4))


class TestShardedMaxSim:
    @pytest.mark.parametrize("n", [130, 5])
    def test_integer_tokens_equal_jax(self, rng, n):
        docs = rng.integers(-3, 4, (n, 7, 16)).astype(np.float32)
        mask = rng.random((n, 7)) > 0.3
        mask[:, 0] = True
        mask[2] = False  # an empty document scores 0.0
        qs = rng.integers(-3, 4, (4, 5, 16)).astype(np.float32)
        sm = tp.ShardedMaxSimCorpus(docs, mask, cpu_mesh())
        jm = jp.ShardedMaxSimCorpus(docs, mask)
        for k in (1, 7, n):
            same(sm.knn(qs, k), jm.knn(qs, k))
        same(sm.knn(qs[0], 5), jm.knn(qs[0], 5))
        same(sm.knn(qs, 5), tt.maxsim_knn_batch(qs, docs, 5, doc_mask=mask))

    def test_bf16_documents_and_edges(self, rng):
        docs = rng.integers(-3, 4, (60, 6, 8)).astype(np.float32)
        qs = rng.integers(-3, 4, (2, 4, 8)).astype(np.float32)
        sm16 = tp.ShardedMaxSimCorpus(docs, mesh=cpu_mesh(), dtype=torch.bfloat16)
        sm = tp.ShardedMaxSimCorpus(docs, mesh=cpu_mesh())
        same(sm16.knn(qs, 5), sm.knn(qs, 5))  # integer tokens are exact in bf16
        assert sm16.memory_bytes() * 2 == sm.memory_bytes()
        assert np_(sm.knn(docs[0], 0)[0]).shape == (0,)
        assert np_(sm.knn(docs[:2], 0)[0]).shape == (2, 0)
        with pytest.raises(tt.ContractError):
            sm.knn(np.zeros((3, 9), np.float32), 2)
        with pytest.raises(tt.ContractError):
            tp.ShardedMaxSimCorpus(docs, np.ones((60, 5), bool), cpu_mesh())


class TestShardedTwoStage:
    @pytest.mark.parametrize("kind", ["binary", "ternary", "u8", "matryoshka"])
    def test_integer_rows_equal_jax_at_the_same_shard_count(self, rng, kind):
        rows = int_rows(rng, 400, 64)
        qs = int_rows(rng, 5, 64)
        cfg = tt.CoarseConfig(kind=kind, threshold=0.5, prefix_dims=16)
        jcfg = it.CoarseConfig(kind=kind, threshold=0.5, prefix_dims=16)
        got = tp.ShardedTwoStageIndex(rows, cfg, 4, cpu_mesh()).search_batch(qs, 6)
        want = jp.ShardedTwoStageIndex(rows, jcfg, 4).search_batch(qs, 6)
        same(got, want)

    @pytest.mark.parametrize("kind", ["binary", "ternary", "u8", "matryoshka"])
    def test_one_shard_equals_the_two_stage_index(self, rng, kind):
        rows = rng.standard_normal((300, 64)).astype(np.float32)
        qs = rows[:5] + 0.01 * rng.standard_normal((5, 64)).astype(np.float32)
        got = tp.ShardedTwoStageIndex(rows, kind, 4, cpu_mesh(1)).search_batch(qs, 3)
        want = tt.TwoStageIndex(rows, kind, 4).search_batch(qs, 3)
        np.testing.assert_array_equal(np_(got[1]), want.indices)
        same((got[0],), (want.scores,))
        np.testing.assert_array_equal(np_(got[1])[:, 0], np.arange(5))
        v1, i1 = tp.ShardedTwoStageIndex(rows, kind, 4, cpu_mesh(1)).search(qs[0], 3)
        np.testing.assert_array_equal(np_(i1), np_(got[1])[0])

    def test_edges_and_memory(self, rng):
        rows = int_rows(rng, 12, 16)
        ts = tp.ShardedTwoStageIndex(rows, "binary", mesh=cpu_mesh())
        assert np_(ts.search_batch(rows[:2], 0)[0]).shape == (2, 0)
        assert np_(ts.search(rows[0], 99)[0]).shape == (12,)
        assert ts.memory_bytes() == {"fine_f32": 12 * 16 * 4, "coarse_binary": 12 * 4}
        with pytest.raises(tt.ContractError):
            tp.ShardedTwoStageIndex(rows, "pq", mesh=cpu_mesh())
        with pytest.raises(tt.ContractError):
            tp.ShardedTwoStageIndex(rows, "binary", 0, cpu_mesh())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestOnCuda:
    def test_four_same_card_shards_equal_the_single_card_calls(self, cuda_device):
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        mesh = tp.default_mesh([cuda_device] * 4)
        rows = torch.randn((20_003, 96), generator=gen, device=cuda_device)
        qs = torch.randn((6, 96), generator=gen, device=cuda_device)
        params = tt.QuantizationParams.fit(rows)
        same(tp.ShardedQuantizedU8.quantize(rows, params, mesh).knn(qs, 10),
             tt.batch_knn_u8_multi(qs, tt.QuantizedU8Batch.quantize(rows, params), params, 10))
        words = tt.encode_binary_batch(rows, 0.0)
        sb = tp.ShardedPackedBinary(words, 96, mesh)
        want = binary_knn_batch(words[:6], tt.PackedBinaryBatch(words, 96), 10)
        same(sb.knn_batch(words[:6], 10), want)
        slots = torch.randint(0, 8, (20_003, 32), generator=gen, device=cuda_device,
                              dtype=torch.int32)
        same(tp.ShardedSlotCorpus(slots, mesh).knn_batch(slots[:6], 10),
             tt.slot_knn_u32_batch(slots[:6], tt.SketchCorpus(slots), 10))
        docs = torch.randn((2_001, 12, 64), generator=gen, device=cuda_device)
        q_tok = torch.randn((3, 8, 64), generator=gen, device=cuda_device)
        same(tp.ShardedMaxSimCorpus(docs, mesh=mesh).knn(q_tok, 10),
             tt.maxsim_knn_batch(q_tok, docs, 10))
