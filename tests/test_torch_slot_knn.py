"""innr_tpu_torch.kernels.slot_knn against innr_tpu's Pallas slot kernels.

The same numpy slots go through the JAX kernels (interpret mode on the CPU,
as innr_tpu's own tests run them) and the port, which runs the plain
version of its CUDA kernel on CPU tensors. Slots are drawn over the full
width (the sign bit of the port's int16 / int32 views included), over a
small alphabet so that counts tie, and some rows are planted copies of a
query, so ties must go to the lowest row. Counts and indices are integers:
equal, never within a tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from innr_tpu.kernels import slot_knn as jsk  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.kernels import row_scan  # noqa: E402
from innr_tpu_torch.kernels import slot_knn as tsk  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch.utils.bits import as_unsigned  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


N = 2100  # >= innr_tpu.config.MIN_ROWS_PALLAS, not a multiple of any tile
DTYPES = {"uint32": np.uint32, "uint16": np.uint16}
# (S, Q): S = 8 is one full sublane chunk of the TPU batch kernel, 9 and 1
# ragged ones.
SHAPES = [(1, 1), (8, 5), (9, 16), (32, 3)]


def slot_data(rng, dtype, s, n_q, n=N):
    """(queries (Q, S), corpus (N, S)): slots from a 4-value alphabet whose
    values set the top bit, so counts tie; rows 50 and 900 copy row 7 and
    query 0 is row 7."""
    bits = np.dtype(dtype).itemsize * 8
    alphabet = np.array([0, 1, 2**(bits - 1), 2**bits - 1], dtype=np.uint64).astype(dtype)
    rows = alphabet[rng.integers(0, 4, (n, s))]
    rows[[50, 900]] = rows[7]
    qs = alphabet[rng.integers(0, 4, (n_q, s))]
    qs[0] = rows[7]
    return qs, rows


def port(arr):
    return as_unsigned(arr, np.dtype(arr.dtype).itemsize * 8)


class TestScanAgainstJax:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("s,n_q", SHAPES)
    def test_batch(self, rng, dtype, s, n_q):
        qs, rows = slot_data(rng, DTYPES[dtype], s, n_q)
        rows_t = np.ascontiguousarray(rows.T)
        jc, ji = jsk.fused_slot_knn_batch(jnp.asarray(qs), jnp.asarray(rows_t), 7)
        tc, ti = tsk.fused_slot_knn_batch(port(qs), port(rows_t), 7)
        assert tc.dtype == torch.int32 and ti.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        if s >= 8:  # no other row matches query 0 exactly
            assert ti[0, :3].tolist() == [7, 50, 900] and (tc[0, :3] == 0).all()

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_single_query(self, rng, dtype):
        qs, rows = slot_data(rng, DTYPES[dtype], 16, 1)
        rows_t = np.ascontiguousarray(rows.T)
        jc, ji = jsk.fused_slot_knn(jnp.asarray(qs[0]), jnp.asarray(rows_t), 5)
        tc, ti = tsk.fused_slot_knn(port(qs[0]), port(rows_t), 5)
        assert tc.shape == (5,)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    def test_ragged_tail_winner(self, rng):
        qs, rows = slot_data(rng, np.uint32, 12, 1)
        rows[-1] = qs[0]
        rows[[7, 50, 900]] += np.uint32(3)  # only the last row matches
        tc, ti = tsk.fused_slot_knn(port(qs[0]), port(np.ascontiguousarray(rows.T)), 2)
        assert ti[0] == N - 1 and tc[0] == 0

    def test_non_contiguous_transpose(self, rng):
        """A raw corpus's slots_t is a transposed view: same result."""
        qs, rows = slot_data(rng, np.uint16, 9, 3)
        view = port(rows).T
        assert not view.is_contiguous()
        got = tsk.fused_slot_knn_batch(port(qs), view, 6)
        want = tsk.fused_slot_knn_batch(port(qs), view.contiguous(), 6)
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    def test_multi_pass_with_cap_patched_down(self, rng, monkeypatch):
        """k beyond the pass cap: exclusion-bounded passes whose
        concatenation equals jax.lax.top_k's single selection (the JAX
        package's path for k above its cap), ties included."""
        monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
        pass_ks, plain_top = [], tsk._plain_top
        monkeypatch.setattr(tsk, "_plain_top", lambda *a: pass_ks.append(a[2]) or plain_top(*a))
        qs, rows = slot_data(rng, np.uint32, 5, 3)
        rows[100:400] = rows[7]  # many ties across pass boundaries
        counts = np.sum(rows[None] != qs[:, None], axis=2)
        _, ji = jax.lax.top_k(-jnp.asarray(counts), 45)
        tc, ti = tsk.fused_slot_knn_batch(port(qs), port(np.ascontiguousarray(rows.T)), 45)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tc.numpy(), np.take_along_axis(counts, np.asarray(ji), 1))
        assert pass_ks == [16, 16, 13]

    def test_plain_exclusion_bound(self, rng):
        """slot_knn_plain's excl resumes strictly after (key, idx)."""
        qs, rows = slot_data(rng, np.uint32, 6, 2)
        q, r = port(qs), port(np.ascontiguousarray(rows.T))
        first_k, first_i = tsk.slot_knn_plain(q, r, 5)
        keys, idx = tsk.slot_knn_plain(q, r, 7, excl=(first_k[:, -1], first_i[:, -1]))
        full_k, full_i = tsk.slot_knn_plain(q, r, 12)
        assert torch.equal(full_i[:, 5:], idx) and torch.equal(full_k[:, 5:], keys)

    def test_plain_chunks_equal_one_selection(self, rng, monkeypatch):
        qs, rows = slot_data(rng, np.uint16, 6, 4)
        q, r = port(qs), port(np.ascontiguousarray(rows.T))
        whole = tsk.slot_knn_plain(q, r, 30)
        monkeypatch.setattr(tsk, "_PLAIN_CHUNK", 1)  # 256-row chunks
        chunked = tsk.slot_knn_plain(q, r, 30)
        assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


class TestDispatchAndContracts:
    def test_force_reference_runs_plain(self, rng, monkeypatch):
        qs, rows = slot_data(rng, np.uint32, 4, 2, n=1000)
        q, r = port(qs), port(np.ascontiguousarray(rows.T))
        want = tsk.slot_knn_plain(q, r, 5)
        monkeypatch.setattr(config, "_FORCE_REFERENCE", True)
        before = tsk.LAUNCHES
        got = tsk.fused_slot_keys_batch(q, r, 5)
        assert all(torch.equal(a, b) for a, b in zip(got, want)) and tsk.LAUNCHES == before

    @pytest.mark.parametrize("bad", [
        dict(k=0),
        dict(k=11),
        dict(qs=torch.ones(2, 3, dtype=torch.int32)),
        dict(qs=torch.ones(2, 2, dtype=torch.int16)),
        dict(slots=torch.ones(2, 10, dtype=torch.int64)),
        dict(slots=torch.ones(10, dtype=torch.int32)),
    ])
    def test_scan_raises(self, bad):
        args = dict(qs=torch.ones(2, 2, dtype=torch.int32),
                    slots=torch.ones(2, 10, dtype=torch.int32), k=3)
        args.update(bad)
        with pytest.raises(ContractError):
            tsk.fused_slot_keys_batch(args["qs"], args["slots"], args["k"])

    def test_meta_device_raises_not_falls_back(self):
        meta = dict(dtype=torch.int32, device="meta")
        with pytest.raises(ContractError, match="unsupported device"):
            tsk.fused_slot_keys_batch(torch.ones(1, 2, **meta), torch.ones(2, 10, **meta), 2)

    @pytest.mark.parametrize("n_q,k,query_bytes,tile", [
        (1, 10, 512, 1), (5, 10, 512, 8), (33, 256, 1024, 16), (16, 256, 12_000, 8),
    ])
    def test_row_scan_tile_fits_shared_memory(self, n_q, k, query_bytes, tile):
        assert row_scan.row_scan_tile(n_q, k, query_bytes, "sparse_scan") == tile

    def test_row_scan_tile_raises_naming_the_limit(self):
        with pytest.raises(ContractError, match="232448"):
            row_scan.row_scan_tile(1, 256, 240_000, "sparse_scan")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestKernelOnCuda:
    @pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
    @pytest.mark.parametrize("n_q,s,k", [(1, 1, 1), (5, 7, 10), (33, 128, 259)])
    def test_scan_matches_plain_exactly(self, cuda_device, dtype, n_q, s, k):
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        info = torch.iinfo(dtype)
        alphabet = torch.tensor([info.min, -1, 0, 1], dtype=dtype, device=cuda_device)
        rows = alphabet[torch.randint(0, 4, (3077, s), generator=gen, device=cuda_device)]
        rows[[100, 2000]] = rows[5].clone()  # an index_put may not read what it writes
        qs = alphabet[torch.randint(0, 4, (n_q, s), generator=gen, device=cuda_device)]
        qs[0] = rows[5]
        slots_t = rows.T.contiguous()
        before = tsk.LAUNCHES
        got = tsk.fused_slot_keys_batch(qs, slots_t, k)
        assert tsk.LAUNCHES > before
        want = tsk.slot_knn_plain(qs, slots_t, k)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
