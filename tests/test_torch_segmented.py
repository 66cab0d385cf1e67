"""innr_tpu_torch.SegmentedCorpus and its npz kind against innr_tpu.

The same add / delete / compact sequences run through both packages; the
counts must agree after every step, and every search must equal the JAX
class's and one full scan (``batch_knn*``) of the alive rows stacked in
permanent-id order: indices exactly, scores bit for bit on integer-valued
rows (every dot and distance exact, many exact ties across segments, which
go to the lowest permanent id). Cosine scores are held to a few ulps (unit
queries are not integers, and the CPU's matmul sums them in an order that
depends on the matrix's shape; on the card the kernel's FMA chain is the
same for every shape, and ``chip_smoke.py`` holds cosine bit for bit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu.io as jio  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
import innr_tpu_torch.io as tio  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


D = 6
MODES = {"dot": ("knn_dot", tt.batch_knn_dot), "l2": ("knn", tt.batch_knn),
         "cosine": ("knn_cosine", tt.batch_knn_cosine)}


def int_rows(rng, n, d=D):
    return rng.integers(-3, 4, (n, d)).astype(np.float32)


def same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def alive_view(rows_by_id: dict):
    ids = np.array(sorted(rows_by_id), dtype=np.int64)
    rows = np.stack([rows_by_id[i] for i in ids]) if len(ids) else np.zeros((0, D), np.float32)
    return rows, ids


def check_search(tsc, jsc, rows_by_id, qs, k, mode):
    method, full = MODES[mode]
    ts, ti = getattr(tsc, method)(qs, k)
    js, ji = getattr(jsc, method)(qs, k)
    rows, ids = alive_view(rows_by_id)
    kk = min(k, len(ids))
    assert ts.shape == (len(qs), max(kk, 0)) and ti.dtype == np.int64
    np.testing.assert_array_equal(ti, np.asarray(ji))
    if mode == "cosine":
        np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-6)
    else:
        assert same_bits(ts, np.asarray(js))
    if kk > 0:
        want = full(qs, tt.VerticalBatch(rows), kk)
        np.testing.assert_array_equal(ti, ids[want.indices])
        if mode == "cosine":
            np.testing.assert_allclose(ts, want.scores, rtol=0, atol=1e-6)
        else:
            assert same_bits(ts, want.scores)


def replay(rng, auto_compact: bool, steps):
    """Run ``steps`` (('add', n) | ('delete', ids) | ('compact',)) through
    both packages, comparing the counts after each; returns both corpora
    and the alive rows by id."""
    tsc = tt.SegmentedCorpus(D, auto_compact=auto_compact, max_segments=3)
    jsc = it.SegmentedCorpus(D, auto_compact=auto_compact, max_segments=3)
    rows_by_id = {}
    for step in steps:
        if step[0] == "add":
            rows = int_rows(rng, step[1])
            got, want = tsc.add(rows), jsc.add(rows)
            assert got == want
            rows_by_id.update({i: r for i, r in zip(range(*got), rows)})
        elif step[0] == "delete":
            assert tsc.delete(step[1]) == jsc.delete(step[1])
            for i in np.atleast_1d(step[1]):
                rows_by_id.pop(int(i), None)
        else:
            tsc.compact()
            jsc.compact()
        for name in ("num_vectors", "num_deleted", "num_segments"):
            assert getattr(tsc, name) == getattr(jsc, name), (step, name)
        assert tsc.num_vectors == len(rows_by_id)
    return tsc, jsc, rows_by_id


STEPS = [("add", 40), ("add", 25), ("delete", [3, 3, 41, 999, -1]), ("add", 30),
         ("delete", list(range(10, 22))), ("add", 12), ("delete", [0, 1, 2, 70, 71]),
         ("compact",), ("add", 9), ("delete", list(range(60, 65)))]


class TestMutations:
    @pytest.mark.parametrize("auto_compact", [False, True])
    def test_replay_counts_and_searches(self, rng, auto_compact):
        tsc, jsc, rows_by_id = replay(rng, auto_compact, STEPS)
        qs = int_rows(rng, 3)
        for mode in MODES:
            for k in (1, 7):
                check_search(tsc, jsc, rows_by_id, qs, k, mode)

    def test_auto_compaction_by_dead_fraction(self, rng):
        tsc, jsc, _ = replay(rng, True, [("add", 40), ("delete", list(range(11)))])
        assert tsc.num_segments == 1 and tsc.num_deleted == 0 and tsc.num_vectors == 29
        tsc.max_dead_frac = 0.5
        assert tsc.delete(list(range(11, 20))) == 9 and tsc.num_deleted == 9

    def test_compact_keeps_ids_and_moves_nothing_off_the_device(self, rng):
        tsc, jsc, rows_by_id = replay(rng, False, STEPS[:7])
        before = tsc.knn_dot(int_rows(rng, 2), 5)
        dev = tsc._segments[0].vb.rows.device
        tsc.compact()
        jsc.compact()
        assert tsc.num_segments == 1 and tsc._segments[0].vb.rows.device == dev
        np.testing.assert_array_equal(tsc._segments[0].ids, np.array(sorted(rows_by_id)))
        qs = int_rows(rng, 4)
        for mode in MODES:
            check_search(tsc, jsc, rows_by_id, qs, 9, mode)
        assert before[1].shape == (2, 5)

    def test_delete_ignores_unknown_and_repeats(self, rng):
        tsc = tt.SegmentedCorpus(D, auto_compact=False)
        tsc.add(int_rows(rng, 10))
        assert tsc.delete([]) == 0 and tsc.delete([-5, 10, 99]) == 0
        assert tsc.delete(np.array([4, 4, 5])) == 2 and tsc.delete(torch.tensor([5, 6])) == 1
        assert tsc.num_vectors == 7 and tsc.num_deleted == 3

    def test_contracts(self, rng):
        with pytest.raises(tt.ContractError):
            tt.SegmentedCorpus(0)
        tsc = tt.SegmentedCorpus(D)
        with pytest.raises(tt.ContractError):
            tsc.add(np.zeros((3, D + 1), np.float32))
        assert tsc.add(np.zeros((0, D), np.float32)) == (0, 0)
        tsc.add(int_rows(rng, 4))
        with pytest.raises(tt.ContractError):
            tsc.knn_dot(np.zeros((2, D + 1), np.float32), 1)

    def test_id_exhaustion(self, rng):
        tsc, jsc = tt.SegmentedCorpus(D), it.SegmentedCorpus(D)
        tsc._next_id = jsc._next_id = 2**31 - 5
        for sc in (tsc, jsc):
            with pytest.raises(it.ContractError if sc is jsc else tt.ContractError,
                               match="exhausted"):
                sc.add(int_rows(rng, 5))
        assert tsc.add(int_rows(rng, 4)) == jsc.add(int_rows(rng, 4)) == (2**31 - 5, 2**31 - 1)

    def test_added_tensor_is_copied(self, rng):
        rows = torch.from_numpy(int_rows(rng, 8))
        tsc = tt.SegmentedCorpus(D)
        tsc.add(rows)
        want = tsc.knn_dot(rows[:2].numpy(), 3)
        rows.zero_()
        got = tsc.knn_dot(int_rows(np.random.default_rng(42), 8)[:2], 3)
        assert tsc._segments[0].vb.rows.abs().sum() > 0 and want[1].shape == got[1].shape

    def test_memory_bytes(self, rng):
        tsc = tt.SegmentedCorpus(D, auto_compact=False)
        assert tsc.memory_bytes() == 0
        tsc.add(int_rows(rng, 10))
        tsc.add(int_rows(rng, 5))
        tsc.delete([1])
        assert tsc.memory_bytes() == 15 * D * 4
        assert tsc.device == torch.device("cpu")


class TestSearch:
    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_k_edges(self, rng, mode):
        tsc, jsc, rows_by_id = replay(rng, False, [("add", 30), ("add", 20),
                                                   ("delete", [0, 5, 33])])
        qs = int_rows(rng, 2)
        alive = len(rows_by_id)
        for k in (0, 1, alive, alive + 3):
            check_search(tsc, jsc, rows_by_id, qs, k, mode)

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_single_query_and_batch(self, rng, mode):
        tsc, jsc, rows_by_id = replay(rng, False, STEPS[:5])
        q = int_rows(rng, 1)[0]
        method = MODES[mode][0]
        s1, i1 = getattr(tsc, method)(q, 6)
        sb, ib = getattr(tsc, method)(q[None, :], 6)
        assert s1.shape == (6,) and i1.shape == (6,)
        np.testing.assert_array_equal(i1, ib[0])
        assert same_bits(s1, sb[0])
        js, ji = getattr(jsc, method)(q, 6)
        np.testing.assert_array_equal(i1, np.asarray(ji))

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_a_fully_dead_segment(self, rng, mode):
        tsc, jsc, rows_by_id = replay(rng, False, [("add", 20), ("add", 15), ("add", 10),
                                                   ("delete", list(range(20, 35)))])
        assert tsc.num_segments == 3 and tsc._segments[1].n_alive == 0
        check_search(tsc, jsc, rows_by_id, int_rows(rng, 3), 8, mode)

    def test_ties_across_segments_go_to_the_lowest_id(self):
        tsc = tt.SegmentedCorpus(2, auto_compact=False)
        row = np.array([[1.0, 2.0]], np.float32)
        tsc.add(np.concatenate([np.zeros((3, 2), np.float32), row]))
        tsc.add(np.concatenate([row, row]))
        tsc.add(row)
        scores, ids = tsc.knn_dot(np.array([1.0, 1.0], np.float32), 4)
        assert ids.tolist() == [3, 4, 5, 6] and scores.tolist() == [3.0] * 4
        tsc.delete([4])
        assert tsc.knn_dot(np.array([1.0, 1.0], np.float32), 3)[1].tolist() == [3, 5, 6]

    def test_empty_and_all_deleted(self, rng):
        tsc = tt.SegmentedCorpus(D, auto_compact=False)
        s, i = tsc.knn(int_rows(rng, 2), 4)
        assert s.shape == (2, 0) and i.shape == (2, 0)
        tsc.add(int_rows(rng, 5))
        tsc.delete(range(5))
        assert tsc.knn_dot(int_rows(rng, 1)[0], 3)[1].shape == (0,)

    def test_nan_rows_sort_greatest(self, rng):
        rows = int_rows(rng, 12)
        rows[4, 0] = np.nan
        rows[9, 2] = np.nan
        tsc = tt.SegmentedCorpus(D, auto_compact=False)
        tsc.add(rows[:6])
        tsc.add(rows[6:])
        q = np.ones(D, np.float32)
        _, ids = tsc.knn_dot(q, 3)
        assert ids[:2].tolist() == [4, 9]
        _, ids = tsc.knn(q, 12)
        assert ids[-2:].tolist() == [4, 9]

    def test_one_scan_per_segment_in_a_masked_mode_where_rows_are_dead(self, rng,
                                                                      monkeypatch):
        tsc, _, _ = replay(rng, False, [("add", 30), ("add", 20), ("delete", [3])])
        modes = []
        real = tk.fused_knn_keys_batch
        monkeypatch.setattr(tk, "fused_knn_keys_batch",
                            lambda *a, **kw: modes.append((a[1].shape[0], a[3], a[4]))
                            or real(*a, **kw))
        tsc.knn(int_rows(rng, 2), 25)
        assert modes == [(30, 25, "l2m"), (20, 20, "l2")]

    def test_k_above_the_pass_cap(self, rng, monkeypatch):
        monkeypatch.setattr(tk, "_K_MAX_PASS", 4)
        tsc, jsc, rows_by_id = replay(rng, False, STEPS[:5])
        for mode in MODES:
            check_search(tsc, jsc, rows_by_id, int_rows(rng, 2), 11, mode)


class TestNpz:
    def test_cross_load_both_ways(self, rng, tmp_path):
        tsc, jsc, rows_by_id = replay(rng, False, STEPS[:7])
        qs = int_rows(rng, 3)
        a, b = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
        tio.save_npz(a, tsc)
        jio.save_npz(b, jsc)
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key])
        t_from_j, j_from_t = tio.load_npz(b), jio.load_npz(a)
        assert t_from_j.num_vectors == len(rows_by_id) and t_from_j.num_segments == 1
        for mode, (method, _) in MODES.items():
            ts, ti = getattr(t_from_j, method)(qs, 5)
            js, ji = getattr(j_from_t, method)(qs, 5)
            np.testing.assert_array_equal(ti, np.asarray(ji))
        assert t_from_j.add(int_rows(rng, 2)) == j_from_t.add(int_rows(rng, 2)) == (107, 109)

    def test_empty_round_trip(self, tmp_path):
        path = str(tmp_path / "e.npz")
        tio.save_npz(path, tt.SegmentedCorpus(3))
        back = tio.load_npz(path)
        assert (back.dimension, back.num_vectors, back._next_id) == (3, 0, 0)
        assert jio.load_npz(path).dimension == 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestOnCuda:
    @pytest.mark.parametrize("k", [10, 300])
    def test_gaussian_segments_equal_the_full_scan_bit_for_bit(self, cuda_device, k):
        """On the card K1's scores are one FMA chain per (row, query), the
        same in any segment, so even Gaussian rows must match exactly."""
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        sc = tt.SegmentedCorpus(64, auto_compact=False, device=cuda_device)
        parts = [torch.randn((n, 64), generator=gen, device=cuda_device)
                 for n in (40_000, 25_000, 33_000)]
        for rows in parts:
            sc.add(rows)
        dead = np.arange(0, 98_000, 9)
        sc.delete(dead)
        alive = np.setdiff1d(np.arange(98_000), dead)
        vb = tt.VerticalBatch(torch.cat(parts)[torch.as_tensor(alive, device=cuda_device)])
        qs = torch.randn((5, 64), generator=gen, device=cuda_device)
        for stage in ("segments", "compacted"):
            for mode, (method, full) in MODES.items():
                s, i = getattr(sc, method)(qs, k)
                want = full(qs, vb, k)
                np.testing.assert_array_equal(i, alive[want.indices])
                assert same_bits(s, want.scores), (stage, mode)
            sc.compact()
