"""Files written by innr_tpu.io.save_npz load into innr_tpu_torch bit for bit
and give the same kNN results (integer-valued data: exact); the port's own
files load back into innr_tpu."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import innr_tpu as it  # noqa: E402
import innr_tpu.io as jio  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
import innr_tpu_torch.io as tio  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


@pytest.fixture
def rows(rng):
    return rng.integers(-4, 5, (2100, 12)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vertical_batch_from_jax_file(tmp_path, rng, rows, dtype):
    jb = it.VerticalBatch(rows, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    path = str(tmp_path / "vb.npz")
    jio.save_npz(path, jb)
    tb = tio.load_npz(path)
    assert tb.rows.dtype == getattr(torch, dtype)
    want_bits = np.asarray(jb.rows).view(np.uint16 if dtype == "bfloat16" else np.int32)
    got_bits = tb.rows.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
    np.testing.assert_array_equal(got_bits.view(want_bits.dtype), want_bits)
    qs = rng.integers(-4, 5, (2, 12)).astype(np.float32)
    for name in ("batch_knn", "batch_knn_dot"):
        a, b = getattr(it, name)(qs, jb, 6), getattr(itt, name)(qs, tb, 6)
        np.testing.assert_array_equal(b.indices, a.indices)
        np.testing.assert_array_equal(b.scores, a.scores)


def test_quantized_batch_from_jax_file(tmp_path, rng):
    codes = rng.integers(0, 256, (2100, 10)).astype(np.uint8)
    path = str(tmp_path / "q.npz")
    jio.save_npz(path, it.QuantizedU8Batch(codes))
    tb = tio.load_npz(path)
    np.testing.assert_array_equal(tb.codes.numpy(), codes)
    q = rng.integers(-3, 4, 10).astype(np.float32)
    params = it.QuantizationParams(2.0, -1.0)
    assert itt.batch_knn_u8(q, tb, itt.QuantizationParams(2.0, -1.0), 5) == it.batch_knn_u8(
        q, it.QuantizedU8Batch(codes), params, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_files_round_trip_and_load_in_jax(tmp_path, rows, dtype):
    tb = itt.VerticalBatch(rows, dtype=dtype)
    path = str(tmp_path / "t.npz")
    tio.save_npz(path, tb)
    back = tio.load_npz(path)
    assert torch.equal(back.rows.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       tb.rows.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    jb = jio.load_npz(path)
    np.testing.assert_array_equal(np.asarray(jb.rows, np.float32), tb.rows.float().numpy())
    qpath = str(tmp_path / "c.npz")
    tio.save_npz(qpath, itt.QuantizedU8Batch(rows.astype(np.uint8)))
    np.testing.assert_array_equal(np.asarray(jio.load_npz(qpath).codes), rows.astype(np.uint8))


def _words(rng, shape):
    """uint32 words over all 32 bits."""
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _jax_packed(kind, rng, dimension):
    w = -(-dimension // 32)
    if kind == "PackedBinary":
        return it.PackedBinary(_words(rng, w), dimension)
    if kind == "PackedBinaryBatch":
        return it.PackedBinaryBatch(_words(rng, (40, w)), dimension)
    a, b = _words(rng, (40, w)), _words(rng, (40, w))
    if kind == "PackedTernary":
        return it.PackedTernary(a[0] & b[0], a[0] & ~b[0], dimension)
    return it.PackedTernaryBatch(a & b, a & ~b, dimension)


def _planes(obj):
    """The container's word planes as uint32 numpy arrays."""
    names = ("words",) if hasattr(obj, "words") else ("pos", "neg")
    out = []
    for name in names:
        t = getattr(obj, name)
        out.append(t.numpy().view(np.uint32) if isinstance(t, torch.Tensor) else np.asarray(t))
    return out


PACKED_KINDS = ["PackedBinary", "PackedBinaryBatch", "PackedTernary", "PackedTernaryBatch"]


@pytest.mark.parametrize("dimension", [77, 96])
@pytest.mark.parametrize("kind", PACKED_KINDS)
def test_packed_kinds_cross_load(tmp_path, rng, kind, dimension):
    """A file saved by innr_tpu loads in the port with the same words (padding
    bits cleared) and the same dimension, and the port's own file loads back
    in innr_tpu equal to the original."""
    jobj = _jax_packed(kind, rng, dimension)
    path = str(tmp_path / "j.npz")
    jio.save_npz(path, jobj)
    tobj = tio.load_npz(path)
    assert type(tobj).__name__ == kind and tobj.dimension == dimension
    for got, want in zip(_planes(tobj), _planes(jobj)):
        np.testing.assert_array_equal(got, want)
    back = str(tmp_path / "t.npz")
    tio.save_npz(back, tobj)
    jback = jio.load_npz(back)
    assert type(jback).__name__ == kind and jback.dimension == dimension
    for got, want in zip(_planes(jback), _planes(jobj)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_sketch_corpus_cross_load(tmp_path, rng, dtype):
    """Slots over the full width (the sign bit of the port's views) keep
    their bits and width both ways, and the loaded corpora give the same
    kNN results."""
    bits = np.dtype(dtype).itemsize * 8
    sketches = rng.integers(0, 2**bits, (2100, 9), dtype=np.uint64).astype(dtype)
    path, back = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jio.save_npz(path, it.SketchCorpus(sketches))
    tobj = tio.load_npz(path)
    assert isinstance(tobj, itt.SketchCorpus) and tobj.bits == bits
    np.testing.assert_array_equal(tobj.sketches.numpy().view(dtype), sketches)
    tio.save_npz(back, tobj)
    jobj = jio.load_npz(back)
    assert isinstance(jobj, it.SketchCorpus) and np.asarray(jobj.sketches).dtype == dtype
    np.testing.assert_array_equal(np.asarray(jobj.sketches), sketches)
    name = f"slot_knn_u{bits}_batch"
    want = getattr(it, name)(sketches[:3], jobj, 5)
    got = getattr(itt, name)(sketches[:3], tobj, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))


def test_sparse_corpus_cross_load(tmp_path, rng):
    """uint32 indices >= 2**31 and the sentinel keep their bits both ways,
    and the loaded corpora give the same kNN results."""
    vocab = np.unique(rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32))
    docs = [(np.sort(rng.choice(vocab, n, replace=False)), rng.integers(-4, 5, n).astype(
        np.float32)) for n in rng.integers(1, 6, 2100)]
    path, back = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jio.save_npz(path, it.SparseCorpus(docs))
    tobj = tio.load_npz(path)
    assert isinstance(tobj, itt.SparseCorpus)
    jref = it.SparseCorpus(docs)
    np.testing.assert_array_equal(tobj.indices.numpy().view(np.uint32), np.asarray(jref.indices))
    np.testing.assert_array_equal(tobj.values.numpy(), np.asarray(jref.values))
    tio.save_npz(back, tobj)
    jobj = jio.load_npz(back)
    np.testing.assert_array_equal(np.asarray(jobj.indices), np.asarray(jref.indices))
    q = docs[5]
    js, ji = it.sparse_knn(q, jobj, 6)
    ts, ti = itt.sparse_knn(q, tobj, 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_unported_kinds_raise(tmp_path):
    # Every kind of the JAX package is ported (the SegmentedCorpus kind
    # last); an empty one loads as an empty corpus, and only unknown kinds
    # and unsupported objects raise.
    path = str(tmp_path / "b.npz")
    jio.save_npz(path, it.SegmentedCorpus(4))
    empty = tio.load_npz(path)
    assert isinstance(empty, itt.SegmentedCorpus)
    assert (empty.dimension, empty.num_vectors, empty.num_segments) == (4, 0, 0)
    np.savez(str(tmp_path / "x.npz"), kind="Mystery")
    with pytest.raises(itt.ContractError, match="unknown"):
        tio.load_npz(str(tmp_path / "x.npz"))
    with pytest.raises(itt.ContractError, match="unsupported"):
        tio.save_npz(path, object())
