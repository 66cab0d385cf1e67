"""innr_tpu_torch.loader and innr_tpu_torch._native against innr_tpu's.

The host encoders must give the bits of the port's on-device encoders
(``encode_binary_batch``, ``encode_ternary_batch``,
``QuantizedU8Batch.quantize``) and of the JAX package's loader, through the
native C runtime and through numpy alike; ``TopK.insert_batch`` must equal
streaming ``insert``. The u8 encoder is held to the JAX loader as it runs
for an ``alpha`` that is a float32 value; for any other ``alpha`` the JAX
loader's C arm rounds ``255 / alpha`` from float32(alpha) and can differ
from its own numpy arm and its on-device encoder (ROADMAP R11), so there
the port is held to those two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
from innr_tpu import _native as j_native  # noqa: E402
from innr_tpu import loader as jloader  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
from innr_tpu_torch import _native as t_native  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch import loader as tloader  # noqa: E402
from innr_tpu_torch.utils.bits import words_to_numpy  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


@pytest.fixture(params=["native", "numpy"])
def arm(request, monkeypatch):
    """Run a test through the native C arm, or with it unavailable."""
    if request.param == "native":
        if not t_native.available():
            pytest.skip("no C compiler here: the native arm cannot be built")
    else:
        monkeypatch.setattr(t_native, "_load", lambda: None)
    return request.param


def rows_of(seed, n=300, d=77):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows[0, :5] = [0.0, -0.0, 0.25, -0.25, 1.0]  # on and around the thresholds
    return rows


class TestEncoders:
    @pytest.mark.parametrize("threshold", [0.0, 0.25])
    def test_binary(self, arm, threshold):
        rows = rows_of(1)
        got = tloader.encode_binary_host(rows, threshold)
        assert isinstance(got, tt.PackedBinaryBatch) and got.dimension == rows.shape[1]
        assert torch.equal(got.words, tt.encode_binary_batch(rows, threshold))
        want = jloader.encode_binary_host(rows, threshold)
        np.testing.assert_array_equal(words_to_numpy(got.words), np.asarray(want.words))

    @pytest.mark.parametrize("threshold", [0.0, 0.25, 1.5])
    def test_ternary(self, arm, threshold):
        rows = rows_of(2)
        got = tloader.encode_ternary_host(rows, threshold)
        pos, neg = tt.encode_ternary_batch(rows, threshold)
        assert torch.equal(got.pos, pos) and torch.equal(got.neg, neg)
        want = jloader.encode_ternary_host(rows, threshold)
        np.testing.assert_array_equal(words_to_numpy(got.pos), np.asarray(want.pos))
        np.testing.assert_array_equal(words_to_numpy(got.neg), np.asarray(want.neg))

    @pytest.mark.parametrize("alpha,offset", [(4.0, -2.0), (3.7, -1.9)])
    def test_u8_with_a_float32_alpha(self, arm, alpha, offset):
        rows = rows_of(3)
        params = tt.QuantizationParams(alpha=float(np.float32(alpha)), offset=offset)
        got = tloader.quantize_u8_host(rows, params)
        assert torch.equal(got.codes, tt.QuantizedU8Batch.quantize(rows, params).codes)
        jparams = it.QuantizationParams(alpha=params.alpha, offset=offset)
        want = jloader.quantize_u8_host(rows, jparams)
        np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))

    def test_u8_with_a_fitted_alpha(self, arm, monkeypatch):
        rows = rows_of(4, n=2000)
        params = tt.QuantizationParams.fit(rows)
        got = tloader.quantize_u8_host(rows, params)
        assert torch.equal(got.codes, tt.QuantizedU8Batch.quantize(rows, params).codes)
        jparams = it.QuantizationParams(alpha=params.alpha, offset=params.offset)
        device = it.QuantizedU8Batch.quantize(rows, jparams)
        np.testing.assert_array_equal(got.codes.numpy(), np.asarray(device.codes))
        monkeypatch.setattr(j_native, "quantize_u8_rows", lambda *a: None)
        numpy_arm = jloader.quantize_u8_host(rows, jparams)
        np.testing.assert_array_equal(got.codes.numpy(), np.asarray(numpy_arm.codes))

    @pytest.mark.parametrize("n_slots", [1, 16])
    def test_minhash(self, arm, n_slots):
        rng = np.random.default_rng(5)
        docs = [rng.integers(0, 2**63, int(rng.integers(0, 40)), dtype=np.uint64)
                for _ in range(30)] + [np.zeros(0, np.uint64)]
        docs[3] = np.array([2**64 - 1, 0, 12345], np.uint64)
        got = tloader.minhash_sketch_host(docs, n_slots)
        want = jloader.minhash_sketch_host(docs, n_slots)
        assert got.dtype == np.uint32 and got.shape == (31, n_slots)
        np.testing.assert_array_equal(got, want)
        assert (got[-1] == 0xFFFFFFFF).all()
        assert tuple(tt.SketchCorpus(got).sketches.shape) == (31, n_slots)

    def test_encoders_put_the_containers_on_the_default_device(self, monkeypatch):
        rows = rows_of(6, n=10, d=40)
        assert tloader.encode_binary_host(rows).words.device.type == "cpu"
        assert tloader.encode_ternary_host(rows, 0.5, device="cpu").pos.device.type == "cpu"
        params = tt.QuantizationParams(2.0, -1.0)
        assert tloader.quantize_u8_host(rows, params).codes.device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        config.set_default_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tloader.encode_binary_host(rows)


class TestHostHelpers:
    """``pack_ternary`` and ``hamming_scan`` over the same C symbols as the
    JAX package's: the same bits on the same inputs, ``None`` without the
    library."""

    @pytest.fixture
    def native(self):
        if not (t_native.available() and j_native.available()):
            pytest.skip("no C compiler here: the native library cannot be built")

    @pytest.mark.parametrize("d", [1, 31, 32, 77])
    @pytest.mark.parametrize("threshold", [0.0, 0.25])
    def test_pack_ternary(self, native, d, threshold):
        v = rows_of(7, n=1, d=max(d, 5))[0, :d]
        pos, neg = t_native.pack_ternary(v, threshold)
        jpos, jneg = j_native.pack_ternary(v, threshold)
        assert pos.dtype == np.uint32 and pos.shape == ((d + 31) // 32,)
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(neg, jneg)
        rows_pos, rows_neg = t_native.pack_ternary_rows(v[None], threshold)
        np.testing.assert_array_equal(pos, rows_pos[0])
        np.testing.assert_array_equal(neg, rows_neg[0])

    @pytest.mark.parametrize("w", [1, 3, 24])
    def test_hamming_scan(self, native, w):
        rng = np.random.default_rng(w)
        corpus = rng.integers(0, 2**32, (50, w), dtype=np.uint64).astype(np.uint32)
        query = rng.integers(0, 2**32, w, dtype=np.uint64).astype(np.uint32)
        corpus[3] = query  # distance 0
        corpus[4] = ~query  # every bit differs
        got = t_native.hamming_scan(query, corpus)
        assert got.dtype == np.uint32 and got.shape == (50,)
        np.testing.assert_array_equal(got, j_native.hamming_scan(query, corpus))
        bits = np.unpackbits((corpus ^ query).view(np.uint8), axis=1).sum(axis=1)
        np.testing.assert_array_equal(got, bits)
        assert got[3] == 0 and got[4] == 32 * w

    def test_none_without_the_library(self, monkeypatch):
        monkeypatch.setattr(t_native, "_load", lambda: None)
        assert t_native.pack_ternary(np.zeros(3, np.float32), 0.0) is None
        assert t_native.hamming_scan(np.zeros(1, np.uint32), np.zeros((2, 1), np.uint32)) is None


class TestTopKInsertBatch:
    @pytest.mark.parametrize("k", [1, 5, 40])
    def test_equals_streaming_insert(self, arm, k):
        rng = np.random.default_rng(k)
        dists = rng.integers(-5, 6, 300).astype(np.float32)
        dists[[7, 50, 51]] = [np.nan, np.inf, -np.inf]
        ids = rng.permutation(300).astype(np.uint32)
        a, b = tt.TopK(k), tt.TopK(k)
        a.insert_batch(ids[:120], dists[:120])
        a.insert_batch(ids[120:], dists[120:])
        for i, d in zip(ids, dists):
            b.insert(int(i), float(d))
        assert len(a) == len(b)
        ra, rb = a.into_sorted(), b.into_sorted()
        assert [i for i, _ in ra] == [i for i, _ in rb]
        np.testing.assert_array_equal(np.array([d for _, d in ra], np.float32),
                                      np.array([d for _, d in rb], np.float32))
        j = it.TopK(k)
        j.insert_batch(ids, dists)
        assert [i for i, _ in j.into_sorted()] == [i for i, _ in ra]


class TestNativeLoader:
    @pytest.fixture
    def fresh(self, tmp_path, monkeypatch):
        if not t_native.available():
            pytest.skip("no C compiler here: the native library cannot be built")
        monkeypatch.setattr(t_native, "_LIB_DIR", tmp_path)
        monkeypatch.setattr(t_native, "_lib", None)
        return tmp_path / t_native._LIB_NAME

    def test_builds_into_its_directory(self, fresh):
        assert t_native._load() is not None and fresh.is_file()

    def test_a_stale_abi_is_rebuilt(self, fresh, tmp_path):
        stale = tmp_path / "stale.c"
        stale.write_text("int innr_native_abi_version(void) { return 2; }\n")
        import subprocess

        subprocess.run(["cc", "-shared", "-fPIC", "-o", str(fresh), str(stale)], check=True)
        lib = t_native._load()
        assert lib is not None and lib.innr_native_abi_version() == 3
        assert t_native.topk_insert_batch(np.ones(3, np.float32), np.arange(3, dtype=np.uint32),
                                          2, np.zeros(2, np.float32), np.zeros(2, np.uint32),
                                          0) == 2

    def test_a_corrupt_library_is_rebuilt(self, fresh):
        fresh.write_bytes(b"not an ELF file")
        assert t_native._load() is not None

    def test_no_compiler_means_no_native(self, fresh, monkeypatch):
        monkeypatch.setattr(t_native, "_SRC", fresh.with_name("missing.c"))
        assert t_native._load() is None and t_native.pack_binary_rows(
            np.zeros((1, 3), np.float32), 0.0) is None

    def test_never_builds_into_the_jax_package(self):
        assert "innr_tpu_torch" in str(t_native._LIB_DIR) and "_native_lib" not in str(
            t_native._LIB_DIR)
