"""innr_tpu_torch.ops.slot against innr_tpu.ops.slot: the pairwise slot ops,
SketchCorpus and the MinHash / slot kNN entry points.

The same numpy slots go through both packages. N = 2100 takes innr_tpu's
fused kernel (interpret mode) for a SketchCorpus, N = 300 its XLA path; the
port runs the plain version of its CUDA kernel on CPU tensors. Slots are
drawn over the full width (values >= 2**31, and >= 2**63 for uint64).
Counts and indices must be equal; similarities equal bit for bit (both
packages compute 1 - count / S in float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.utils.bits import as_unsigned  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def full_width(rng, shape, dtype, alphabet=None):
    """Slots over the whole width of ``dtype`` (the top bit set often);
    with ``alphabet``, drawn from that many values so that counts tie."""
    bits = np.dtype(dtype).itemsize * 8
    if alphabet is None:
        return rng.integers(0, 2**bits, shape, dtype=np.uint64).astype(dtype)
    values = rng.integers(0, 2**bits, alphabet, dtype=np.uint64).astype(dtype)
    values[0] = np.iinfo(dtype).max
    return values[rng.integers(0, alphabet, shape)]


def corpus_data(rng, n, s, dtype, n_q=3):
    rows = full_width(rng, (n, s), dtype, alphabet=3)
    rows[[40, 90]] = rows[11]
    qs = full_width(rng, (n_q, s), dtype, alphabet=3)
    qs[0] = rows[11]
    return qs, rows


def same(got, want):
    """Port tensors against JAX arrays, exactly (integers or float bits)."""
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


class TestPairwise:
    @pytest.mark.parametrize("n", [0, 1, 7, 33, 257])
    def test_hamming_u32_u16_u64(self, rng, n):
        for dtype, jf, tf in ((np.uint32, it.slot_hamming_u32, itt.slot_hamming_u32),
                              (np.uint16, it.slot_hamming_u16, itt.slot_hamming_u16),
                              (np.uint64, it.slot_hamming_u64, itt.slot_hamming_u64)):
            a = full_width(rng, n, dtype)
            b = a.copy()
            b[rng.random(n) < 0.4] ^= dtype(1)
            if dtype == np.uint64 and n:
                b[0] = a[0] ^ np.uint64(1 << 63)  # differs only in the top bit
            got = tf(a, b)
            assert got.dtype == torch.int32
            assert int(got) == int(jf(a, b))

    def test_u64_as_int64_views(self, rng):
        a = full_width(rng, 50, np.uint64)
        b = a.copy()
        b[::3] += np.uint64(1)
        assert int(itt.slot_hamming_u64(torch.from_numpy(a.view(np.int64)), b)) == int(
            it.slot_hamming_u64(a, b))

    def test_narrower_views_widen_as_unsigned(self, rng):
        """A uint16 sketch as its int16 view meets a uint32 one as JAX's
        zero-extended uint16 does (65535 stays 65535, not 2**32 - 1)."""
        a = full_width(rng, 64, np.uint16)
        a[:4] = np.iinfo(np.uint16).max
        b = a.astype(np.uint32)
        b[::5] += np.uint32(1)
        got = itt.slot_hamming_u32(torch.from_numpy(a.view(np.int16)), b)
        assert int(got) == int(it.slot_hamming_u32(a, b)) == int(np.sum(a != b))
        assert int(as_unsigned(torch.from_numpy(a.view(np.int16)), 32)[0]) == 65535

    @pytest.mark.parametrize("fn", ["slot_hamming_u32", "slot_hamming_u16", "slot_hamming_u64",
                                    "minhash_jaccard", "jaccard_distance"])
    def test_length_mismatch_raises(self, fn):
        with pytest.raises(itt.ContractError, match="length mismatch"):
            getattr(itt, fn)(np.zeros(3, np.uint32), np.zeros(4, np.uint32))

    def test_generic_hamming_min_length(self, rng):
        a = full_width(rng, 20, np.uint64)
        b = a[:12].copy()
        b[3] ^= np.uint64(1 << 63)
        assert itt.slot_hamming(a, b) == it.slot_hamming(a, b) == 1
        assert itt.slot_hamming([1, 2, 3], [1, 9]) == it.slot_hamming([1, 2, 3], [1, 9]) == 1
        assert itt.slot_hamming([], [1]) == 0

    @pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
    def test_compare_counts_unsigned_order(self, rng, dtype):
        a = full_width(rng, 200, dtype)
        b = full_width(rng, 200, dtype)
        b[::7] = a[::7]
        want = it.slot_compare_counts(a, b)
        bits = np.dtype(dtype).itemsize * 8
        views = (torch.from_numpy(a.view(f"int{bits}")), torch.from_numpy(b.view(f"int{bits}")))
        for args in ((a, b), views, (views[0], b)):
            got = itt.slot_compare_counts(*args)
            assert (got.eq, got.lt, got.gt) == (want.eq, want.lt, want.gt)
        assert got.eq + got.lt + got.gt == 200 and got.eq >= 29

    def test_compare_counts_top_bit(self):
        """A slot with the top bit set is the larger: a signed compare of
        the views would say otherwise."""
        for dtype in (np.uint32, np.uint64):
            top = np.iinfo(dtype).max // 2 + 1
            a, b = np.array([top, 1, 5], dtype), np.array([1, top, 5], dtype)
            c = itt.slot_compare_counts(a, b)
            assert (c.eq, c.lt, c.gt) == (1, 1, 1)
            j = it.slot_compare_counts(a, b)
            assert (j.eq, j.lt, j.gt) == (1, 1, 1)
        assert itt.slot_compare_counts([1, 2, 3], [1]) == itt.SlotCounts(1, 0, 0)
        assert itt.slot_compare_counts([], []) == itt.SlotCounts()

    def test_jaccard(self, rng):
        a = full_width(rng, 128, np.uint32, alphabet=4)
        b = full_width(rng, 128, np.uint32, alphabet=4)
        same((itt.minhash_jaccard(a, b), itt.jaccard_distance(a, b)),
             (it.minhash_jaccard(a, b), it.jaccard_distance(a, b)))
        z = np.zeros(0, np.uint32)
        assert float(itt.minhash_jaccard(z, z)) == 1.0
        assert float(itt.jaccard_distance(z, z)) == 0.0

    def test_batch_slot_hamming(self, rng):
        qs, rows = corpus_data(rng, 300, 24, np.uint32)
        got = itt.batch_slot_hamming_u32(qs[0], rows)
        assert got.dtype == torch.int32
        same((got,), (it.batch_slot_hamming_u32(qs[0], rows),))
        with pytest.raises(itt.ContractError, match="length mismatch"):
            itt.batch_slot_hamming_u32(qs[0][:5], rows)


class TestSketchCorpus:
    @pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
    def test_layout_and_memory(self, rng, dtype):
        _, rows = corpus_data(rng, 120, 12, dtype)
        jc, tc = it.SketchCorpus(rows), itt.SketchCorpus(rows)
        bits = np.dtype(dtype).itemsize * 8
        assert tc.bits == bits and tc.dtype == getattr(torch, f"int{bits}")
        assert (tc.num_sketches, tc.num_slots) == (jc.num_sketches, jc.num_slots)
        assert tc.memory_bytes() == jc.memory_bytes()
        assert tc.slots_t.is_contiguous() and torch.equal(tc.slots_t, tc.sketches.T)
        np.testing.assert_array_equal(tc.sketches.numpy().view(dtype), np.asarray(jc.sketches))

    def test_dtype_argument(self, rng):
        rows = full_width(rng, (20, 8), np.uint16)
        assert itt.SketchCorpus(rows, dtype=np.uint32).bits == 32
        assert itt.SketchCorpus(rows.astype(np.uint32), dtype=jnp.uint32).bits == 32
        assert itt.SketchCorpus(as_unsigned(rows, 16)).bits == 16  # an int16 view
        assert itt.SketchCorpus(rows.tolist()).bits == 32
        with pytest.raises(itt.ContractError, match="uint16 or uint32"):
            itt.SketchCorpus(rows, dtype=np.float32)
        with pytest.raises(itt.ContractError, match="2-D"):
            itt.SketchCorpus(rows[0])

    @pytest.mark.parametrize("call", [
        lambda r: itt.SketchCorpus(r.astype(np.uint64)),
        lambda r: itt.SketchCorpus(r.astype(np.uint32), dtype=np.uint16),
        lambda r: itt.SketchCorpus(torch.from_numpy(r.astype(np.int64))),
        lambda r: itt.slot_knn_u16(r[0].astype(np.uint32), r.astype(np.uint16), 2),
        lambda r: itt.slot_knn_u16(r[0].astype(np.uint16), r.astype(np.uint32), 2),
        lambda r: itt.slot_knn_u16(as_unsigned(r[0], 32), r.astype(np.uint16), 2),
        lambda r: itt.slot_knn_u16_batch(r[:2].astype(np.uint32), r.astype(np.uint16), 2),
        lambda r: itt.slot_knn_u32(r[0].astype(np.uint64), r.astype(np.uint32), 2),
        lambda r: itt.slot_knn_u32_batch(r[:2].astype(np.uint32), r.astype(np.uint64), 2),
    ])
    def test_narrowing_raises(self, rng, call):
        rows = full_width(rng, (30, 6), np.uint16)
        with pytest.raises(itt.ContractError, match="would be truncated"):
            call(rows)

    @pytest.mark.parametrize("call", [
        lambda r: it.SketchCorpus(r.astype(np.uint64)),
        lambda r: it.slot_knn_u16(r[0].astype(np.uint32), r.astype(np.uint16), 2),
        lambda r: it.slot_knn_u32_batch(r[:2].astype(np.uint32), r.astype(np.uint64), 2),
    ])
    def test_narrowing_raises_in_jax_too(self, rng, call):
        with pytest.raises(it.ContractError, match="would be truncated"):
            call(full_width(rng, (30, 6), np.uint16))

    def test_container_width_must_match(self, rng):
        rows = full_width(rng, (30, 6), np.uint16)
        with pytest.raises(itt.ContractError, match="does not match"):
            itt.slot_knn_u32(rows[0].astype(np.uint32), itt.SketchCorpus(rows), 2)
        with pytest.raises(itt.ContractError, match="1-D"):
            itt.slot_knn_u16(rows[:2], itt.SketchCorpus(rows), 2)
        with pytest.raises(itt.ContractError, match="2-D"):
            itt.slot_knn_u16_batch(rows[0], itt.SketchCorpus(rows), 2)
        with pytest.raises(itt.ContractError, match="length mismatch"):
            itt.slot_knn_u16(rows[0, :5], itt.SketchCorpus(rows), 2)


# N = 2100 takes innr_tpu's fused kernel for a SketchCorpus, 300 its XLA path.
SIZES = [(2100, 16), (300, 9)]


class TestKnnAgainstJax:
    @pytest.mark.parametrize("n,s", SIZES)
    @pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
    @pytest.mark.parametrize("container", [True, False])
    def test_slot_knn(self, rng, n, s, dtype, container):
        qs, rows = corpus_data(rng, n, s, dtype, n_q=5)
        suffix = "u16" if dtype == np.uint16 else "u32"
        jc = it.SketchCorpus(rows) if container else rows
        tc = itt.SketchCorpus(rows) if container else rows
        jf, tf = getattr(it, f"slot_knn_{suffix}"), getattr(itt, f"slot_knn_{suffix}")
        got = tf(qs[0], tc, 9)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        same(got, jf(qs[0], jc, 9))
        assert got[1][:3].tolist() == [11, 40, 90]
        jb, tb = getattr(it, f"slot_knn_{suffix}_batch"), getattr(itt, f"slot_knn_{suffix}_batch")
        same(tb(qs, tc, 9), jb(qs, jc, 9))

    @pytest.mark.parametrize("n,s", SIZES)
    @pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
    def test_minhash_knn(self, rng, n, s, dtype):
        qs, rows = corpus_data(rng, n, s, dtype, n_q=4)
        sims, idx = itt.minhash_knn(qs[1], itt.SketchCorpus(rows), 6)
        assert sims.dtype == torch.float32
        same((sims, idx), it.minhash_knn(qs[1], it.SketchCorpus(rows), 6))
        same(itt.minhash_knn_batch(qs, rows, 6), it.minhash_knn_batch(qs, rows, 6))
        # The width follows the corpus: a u16 corpus with u16 queries, a
        # list corpus with u16 queries.
        same(itt.minhash_knn(qs[1], rows.tolist(), 6), it.minhash_knn(qs[1], rows.tolist(), 6))

    def test_tensor_inputs_keep_their_device(self, rng):
        qs, rows = corpus_data(rng, 300, 9, np.uint32)
        corpus = as_unsigned(rows, 32)
        counts, idx = itt.slot_knn_u32_batch(as_unsigned(qs, 32), corpus, 4)
        assert counts.device == corpus.device
        same((counts, idx), it.slot_knn_u32_batch(qs, rows, 4))

    @pytest.mark.parametrize("k", [0, -1, 5000])
    def test_k_edges(self, rng, k):
        qs, rows = corpus_data(rng, 300, 8, np.uint32)
        for t, j in ((itt.slot_knn_u32(qs[0], rows, k), it.slot_knn_u32(qs[0], rows, k)),
                     (itt.slot_knn_u32_batch(qs, rows, k), it.slot_knn_u32_batch(qs, rows, k)),
                     (itt.minhash_knn_batch(qs, rows, k), it.minhash_knn_batch(qs, rows, k))):
            assert tuple(t[0].shape) == np.asarray(j[0]).shape
            same(t, j)

    def test_empty_corpus_and_batch(self):
        rows = np.zeros((0, 4), np.uint32)
        counts, idx = itt.slot_knn_u32(np.zeros(4, np.uint32), rows, 3)
        assert counts.shape == (0,) and idx.shape == (0,)
        counts, idx = itt.slot_knn_u32_batch(np.zeros((2, 4), np.uint32), rows, 3)
        assert counts.shape == (2, 0)
        counts, idx = itt.slot_knn_u32_batch(np.zeros((0, 4), np.uint32),
                                             np.ones((5, 4), np.uint32), 3)
        assert counts.shape == (0, 3)
