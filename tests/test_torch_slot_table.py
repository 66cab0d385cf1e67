"""The slot scans' plan and table (innr_tpu_torch.kernels.slot_knn).

``slot_table_plain`` builds each query tile's per-slot filter and table as
the CUDA kernel ``slot_table`` builds them in shared memory (the same
hashes, filter bits and linear probing) and looks every (slot, row) up
through them. Its equal counts must be the direct compare's on any data:
full-width uint16 / uint32 slots (the views' sign bit set), a 4-value
corpus where nearly every lookup hits, queries that share a value at a
slot, and every slot count and query tile the plan can give. Then the
plan (the mode by query count, the shared memory beside its limit, the
tile halved), the public slot kNN against the JAX package's
``fused_slot_knn(_batch)`` (interpret mode on the CPU) at a few hundred
rows, and, on a card, each mode against ``slot_knn_plain`` bit for bit.
Counts and indices are integers: equal, never within a tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import innr_tpu_torch as itt  # noqa: E402
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


NP_DTYPES = {16: np.uint16, 32: np.uint32}


def slots(rng, bits, shape, kind):
    """Unsigned slots: "full" over the whole width (half with the top bit
    set), "four" from a 4-value alphabet with the top bit set in two."""
    if kind == "full":
        return rng.integers(0, 2**bits, shape, dtype=np.uint64).astype(NP_DTYPES[bits])
    alphabet = np.array([0, 1, 2**(bits - 1), 2**bits - 1], dtype=np.uint64)
    return alphabet[rng.integers(0, 4, shape)].astype(NP_DTYPES[bits])


def sketch_data(rng, bits, s, n_q, kind, n=300):
    """``(queries (Q, S), corpus (N, S))`` as port tensors: queries 0 and
    1 are corpus rows 7 and 11 (copied to rows 50 and 200), and query 1
    shares query 0's value at every third slot."""
    rows = slots(rng, bits, (n, s), kind)
    rows[50], rows[200] = rows[7], rows[11]
    qs = slots(rng, bits, (n_q, s), kind)
    qs[0] = rows[7]
    if n_q > 1:
        qs[1] = rows[11]
        qs[1, ::3] = qs[0, ::3]
    return as_unsigned(qs, bits), as_unsigned(rows, bits)


def direct_equal(qs, slots_t):
    return (slots_t[None] == qs[:, :, None]).sum(dim=1, dtype=torch.int32)


class TestTableModel:
    @pytest.mark.parametrize("bits", [16, 32])
    @pytest.mark.parametrize("kind", ["full", "four"])
    @pytest.mark.parametrize("s", [1, 7, 128, 300])
    @pytest.mark.parametrize("tile", [1, 2, 16, 32])
    def test_equal_counts_are_the_direct_compare(self, rng, bits, kind, s, tile):
        qs, rows = sketch_data(rng, bits, s, tile + 1, kind)  # a ragged last tile
        slots_t = rows.T.contiguous()
        got = tsk.slot_table_plain(qs, slots_t, tile)
        assert torch.equal(got.equal, direct_equal(qs, slots_t))
        # Every true hit passes the filter and finds its entry.
        per_tile = [(slots_t[None] == qs[q0:q0 + tile, :, None]).any(dim=0)
                    for q0 in range(0, qs.shape[0], tile)]
        assert got.hits == sum(int(h.sum()) for h in per_tile) <= got.passes

    @pytest.mark.parametrize("bits", [16, 32])
    @pytest.mark.parametrize("tile", [1, 2, 4, 8, 16, 32])
    def test_entries_map_each_value_to_its_queries(self, rng, bits, tile):
        """Each (slot, value) of the tile has one entry whose mask is the
        set of queries holding it; the rest are empty; at most two thirds
        full."""
        qs, _ = sketch_data(rng, bits, 40, tile, "four")
        q = qs.to(torch.int64) & ((1 << bits) - 1)
        filt, vals, masks = tsk.slot_table_build(q, tile)
        assert vals.shape == masks.shape == (40, tsk.table_entries(tile))
        assert filt.shape == (40, tsk.FILTER_WORDS)
        for sl in range(40):
            want = {}
            for j, v in enumerate(q[:, sl].tolist()):
                want[v] = want.get(v, 0) | 1 << j
            live = masks[sl] != 0
            got = dict(zip(vals[sl][live].tolist(), masks[sl][live].tolist()))
            assert got == want
            assert 3 * int(live.sum()) <= 2 * masks.shape[1] and not live.all()

    def test_filter_rejects_most_full_width_misses(self, rng):
        """At full width a miss passes the filter about (l + l^2) / 256 of
        the time, l = tile / 32 (0.3% at 16 queries)."""
        qs, rows = sketch_data(rng, 32, 128, 16, "full", n=2000)
        got = tsk.slot_table_plain(qs, rows.T.contiguous(), 16)
        lookups = 128 * 2000
        assert got.passes - got.hits < 0.006 * lookups

    def test_rows_in_chunks_equal_one_pass(self, rng):
        qs, rows = sketch_data(rng, 32, 7, 3, "four")
        slots_t = rows.T.contiguous()
        whole = tsk.slot_table_plain(qs, slots_t, 4)
        chunked = tsk.slot_table_plain(qs, slots_t, 4, chunk=64)
        assert torch.equal(whole.equal, chunked.equal)
        assert (whole.passes, whole.hits) == (chunked.passes, chunked.hits)

    @pytest.mark.parametrize("v", [0, 1, 0xFFFF, 0x8000_0000, 0xFFFF_FFFF, 0x1234_5678])
    def test_hash_is_the_32_bit_product(self, v):
        for mul in (tsk.FILTER_MUL, tsk.TABLE_MUL):
            want = (v * mul) % 2**32
            assert tsk._mul32(v, mul) == want
            assert int(tsk._mul32(torch.tensor([v], dtype=torch.int64), mul)) == want


class TestPlan:
    @pytest.mark.parametrize("n_q,want", [
        (1, ("compare", 1)), (2, ("compare", 2)), (3, ("compare", 4)), (4, ("compare", 4)),
        (5, ("table", 8)), (16, ("table", 16)), (17, ("table", 32)), (32, ("table", 32)),
        (33, ("table", 32)), (500, ("table", 32)),
    ])
    def test_mode_by_query_count(self, n_q, want):
        assert tsk.COMPARE_MAX_TILE == 4
        for bits in (16, 32):
            assert tsk.plan(n_q, 10, 128, bits) == want

    @pytest.mark.parametrize("cut,n_q,want", [
        (32, 1, ("compare", 1)), (32, 33, ("compare", 4)), (0, 1, ("table", 1)),
        (0, 2, ("table", 2)),
    ])
    def test_the_crossover_selects_one_scan_at_every_q(self, monkeypatch, cut, n_q, want):
        """The checks on the card run each scan at every Q by moving the
        crossover: past every tile (compare), or below the first (table)."""
        monkeypatch.setattr(tsk, "COMPARE_MAX_TILE", cut)
        assert tsk.plan(n_q, 10, 128, 16) == want

    @pytest.mark.parametrize("bits,mode,tile,s,k,want", [
        # top-k buffers max(tile, 8) x k, max(16, tile) bounds, tile x rows keys
        (16, "table", 16, 128, 10, 8 * (16 * 10 + 16) + 4 * 16 * 256 + 128 * (128 + 8 * 25)),
        (32, "table", 32, 128, 10, 8 * (32 * 10 + 32) + 4 * 32 * 256 + 128 * (128 + 8 * 49)),
        (32, "table", 1, 7, 256, 8 * (8 * 256 + 16) + 4 * 256 + 7 * (128 + 8 * 2)),
        (16, "compare", 1, 128, 10, 8 * (8 * 10 + 16) + 4 * 2048 + 4 * 128),
        (32, "compare", 4, 128, 256, 8 * (8 * 256 + 16) + 4 * 4 * 1024 + 4 * 128 * 4),
    ])
    def test_shared_memory(self, bits, mode, tile, s, k, want):
        assert tsk.smem_bytes(bits, mode, tile, s, k) == want

    def test_table_bytes_halve_the_tile(self):
        """32 queries x 300 slots fit at k = 10; at k = 256 the top-k
        buffers push the table tile down to 16, and wider sketches further,
        until a table tile at the crossover or below gives way to the
        compare scan."""
        assert tsk.plan(32, 10, 300, 32) == ("table", 32)
        assert tsk.smem_bytes(32, "table", 32, 300, 256) > row_scan.SMEM_LIMIT
        assert tsk.plan(32, 256, 300, 32) == ("table", 16)
        assert tsk.plan(32, 10, 800, 16) == ("table", 8)
        assert tsk.smem_bytes(16, "table", 8, 1200, 10) > row_scan.SMEM_LIMIT
        assert tsk.smem_bytes(16, "table", 4, 1200, 10) <= row_scan.SMEM_LIMIT
        assert tsk.plan(32, 10, 1200, 16) == ("compare", 4)

    @pytest.mark.parametrize("bits", [16, 32])
    @pytest.mark.parametrize("n_q,k,s,want", [
        (16, 10, 2000, ("compare", 4)),
        (16, 256, 3000, ("compare", 4)),  # one table query does not fit
        (5, 10, 12_000, ("compare", 4)),
        (2, 256, 20_000, ("compare", 2)),
        (33, 256, 50_000, ("compare", 1)),
    ])
    def test_wide_sketches_run_the_compare_scan(self, bits, n_q, k, s, want):
        """Where no table tile above the crossover fits, the compare scan
        (4 bytes a slot and query) runs at its largest tile that fits."""
        assert tsk.smem_bytes(bits, "table", 1, s, k) > row_scan.SMEM_LIMIT
        assert tsk.plan(n_q, k, s, bits) == want
        assert tsk.smem_bytes(bits, *want, s, k) <= row_scan.SMEM_LIMIT

    def test_the_table_scan_gives_way_only_above_the_crossover(self, monkeypatch):
        """With the crossover below every tile (the checks' table-only
        setting) the table runs at one query while it fits."""
        monkeypatch.setattr(tsk, "COMPARE_MAX_TILE", 0)
        assert tsk.plan(16, 10, 1200, 16) == ("table", 4)
        assert tsk.plan(16, 10, 1500, 16) == ("table", 1)
        assert tsk.plan(16, 10, 2000, 16) == ("compare", 4)

    def test_one_query_that_does_not_fit_raises_naming_the_limit(self):
        with pytest.raises(ContractError, match="232448"):
            tsk.plan(1, 10, 60_000, 16)
        with pytest.raises(ContractError, match="232448"):
            tsk.plan(16, 256, 60_000, 32)

    @pytest.mark.parametrize("bits,mode,rows", [
        (16, "compare", 2048), (32, "compare", 1024), (16, "table", 256), (32, "table", 256),
    ])
    def test_row_tiles(self, bits, mode, rows):
        assert tsk.row_tile(bits, mode) == rows

    def test_table_entries_at_most_two_thirds_full(self):
        assert [tsk.table_entries(t) for t in (1, 2, 4, 8, 16, 32)] == [2, 4, 7, 13, 25, 49]


class TestPublicAgainstJax:
    @pytest.mark.parametrize("bits", [16, 32])
    @pytest.mark.parametrize("kind", ["full", "four"])
    @pytest.mark.parametrize("n_q", [1, 2, 17, 33])
    def test_batch(self, rng, bits, kind, n_q):
        qs, rows = sketch_data(rng, bits, 24, n_q, kind, n=300)
        rows_t = rows.T.contiguous()
        np_q = qs.numpy().view(NP_DTYPES[bits])
        np_t = rows_t.numpy().view(NP_DTYPES[bits])
        jc, ji = jsk.fused_slot_knn_batch(jnp.asarray(np_q), jnp.asarray(np_t), 9)
        fn = itt.slot_knn_u16_batch if bits == 16 else itt.slot_knn_u32_batch
        tc, ti = fn(qs, itt.SketchCorpus(rows), 9)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    @pytest.mark.parametrize("bits", [16, 32])
    def test_single(self, rng, bits):
        qs, rows = sketch_data(rng, bits, 24, 1, "full", n=300)
        rows_t = rows.T.contiguous()
        jc, ji = jsk.fused_slot_knn(jnp.asarray(qs[0].numpy().view(NP_DTYPES[bits])),
                                    jnp.asarray(rows_t.numpy().view(NP_DTYPES[bits])), 4)
        fn = itt.slot_knn_u16 if bits == 16 else itt.slot_knn_u32
        tc, ti = fn(qs[0], itt.SketchCorpus(rows), 4)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti[:2].tolist() == [7, 50]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestModesOnCuda:
    @pytest.mark.parametrize("mode,cut", [("compare", 32), ("table", 0)])
    @pytest.mark.parametrize("bits", [16, 32])
    @pytest.mark.parametrize("kind", ["full", "four"])
    @pytest.mark.parametrize("n", [3077, 3080])  # slot rows off / on 16-byte boundaries
    def test_mode_matches_plain_exactly(self, cuda_device, rng, monkeypatch, mode, cut, bits,
                                        kind, n):
        monkeypatch.setattr(tk, "_K_MAX_PASS", 64)  # k = 259 runs five passes
        monkeypatch.setattr(tsk, "COMPARE_MAX_TILE", cut)  # this scan at every Q
        for n_q in (1, 2, 17, 32, 33):
            qs, rows = sketch_data(rng, bits, 128, n_q, kind, n=n)
            qs, slots_t = qs.to(cuda_device), rows.T.contiguous().to(cuda_device)
            for k in (1, 10, 259):
                before = tsk.LAUNCHES_BY_MODE[mode]
                got = tsk.fused_slot_keys_batch(qs, slots_t, k)
                assert tsk.LAUNCHES_BY_MODE[mode] > before
                want = tsk.slot_knn_plain(qs, slots_t, k)
                assert all(torch.equal(x, y) for x, y in zip(got, want)), (n_q, k)

    @pytest.mark.parametrize("bits", [16, 32])
    @pytest.mark.parametrize("n", [3077, 3080])
    def test_wide_sketches_run_the_compare_scan(self, cuda_device, rng, bits, n):
        """2000 slots: no table tile fits, so 16 queries run the compare
        scan at tile 4."""
        qs, rows = sketch_data(rng, bits, 2000, 16, "full", n=n)
        qs, slots_t = qs.to(cuda_device), rows.T.contiguous().to(cuda_device)
        assert tsk.plan(16, 10, 2000, bits) == ("compare", 4)
        for k in (1, 10):
            before = tsk.LAUNCHES_BY_MODE["compare"]
            got = tsk.fused_slot_keys_batch(qs, slots_t, k)
            assert tsk.LAUNCHES_BY_MODE["compare"] > before
            want = tsk.slot_knn_plain(qs, slots_t, k)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), k

    def test_library_agrees_with_the_plan(self, cuda_device):
        from innr_tpu_torch.kernels import _build

        lib = _build.load()
        for bits in (16, 32):
            for mode, (mode_id, tiles) in tsk.MODES.items():
                for tile in tiles:
                    for s in (1, 7, 128, 300):
                        for k in (1, 10, 256):
                            assert (lib.innr_slot_smem_bytes(bits, mode_id, tile, s, k)
                                    == tsk.smem_bytes(bits, mode, tile, s, k))
