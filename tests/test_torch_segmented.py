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
import innr_tpu_torch.parallel as tp  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402


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


def near_copy_input():
    """ROADMAP's F5 input: 5,000 unit rows of D = 96, the query row 1234, and
    30 rows replaced by near-copies of it (q + 3e-6 N(0, 1), renormalised).
    In L2 the copies' keys differ but 14 rows clamp to 0.0 once ||q||^2 is
    added back, so only K1's key order separates them."""
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((5000, 96)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = rows[1234].copy()
    near = rng.choice(5000, 30, replace=False)
    copies = q + 3e-6 * rng.standard_normal((30, 96)).astype(np.float32)
    rows[near] = copies / np.linalg.norm(copies, axis=1, keepdims=True)
    return rows, q[None, :], near


def clamped_ties_on_every_path(rows, qs, k, device):
    """``batch_knn``, ``SegmentedCorpus`` (two segments), ``ShardedCorpus``
    (four shards) and ``IVFIndex`` (four clusters) in L2 on ``device``,
    each as (scores, ids) numpy arrays."""
    vb = tt.VerticalBatch(torch.as_tensor(rows, device=device))
    full = tt.batch_knn(torch.as_tensor(qs, device=device), vb, k)
    sc = tt.SegmentedCorpus(rows.shape[1], auto_compact=False, device=device)
    sc.add(rows[:2500])
    sc.add(rows[2500:])
    shard_s, shard_i = tp.ShardedCorpus(rows, tp.default_mesh([device] * 4)).knn_l2(qs, k)
    ivf = tt.IVFIndex(rows, n_clusters=4, metric="l2", device=device).search_batch(qs, k)
    return {"batch_knn": (full.scores, full.indices), "segmented": sc.knn(qs, k),
            "sharded": (shard_s.cpu().numpy(), shard_i.cpu().numpy()),
            "ivf": (ivf.scores, ivf.indices)}


def assert_one_answer(paths, k):
    """Every path's answer is ``batch_knn``'s bit for bit, and each of its
    k scores is 0.0 (the callers check that more than k rows clamp, so the
    case rests on the tie order)."""
    want_s, want_i = paths["batch_knn"]
    assert (np.asarray(want_s) == 0.0).all() and np.asarray(want_s).shape == (1, k)
    for name, (s, i) in paths.items():
        np.testing.assert_array_equal(np.asarray(i, np.int64), np.asarray(want_i), err_msg=name)
        assert same_bits(s, want_s), name


class TestF5ClampedTies:
    """Where L2 distances clamp to 0.0 the segmented search keeps K1's key
    order, as one full scan, the shards and IVF do (ROADMAP F5)."""

    def test_every_path_returns_the_full_scans_answer(self):
        rows, qs, _ = near_copy_input()
        wide = tt.batch_knn(qs, tt.VerticalBatch(rows), 20)
        assert int((wide.scores == 0.0).sum()) > 10
        assert_one_answer(clamped_ties_on_every_path(rows, qs, 10, "cpu"), 10)

    @pytest.mark.parametrize("method", ["knn", "knn_dot", "knn_cosine"])
    def test_with_dead_near_copies_across_segments(self, method):
        rows, qs, near = near_copy_input()
        sc = tt.SegmentedCorpus(96, auto_compact=False)
        for s in range(0, 5000, 1250):
            sc.add(rows[s:s + 1250])
        dead = np.sort(near[::3])
        sc.delete(dead)
        alive = np.setdiff1d(np.arange(5000), dead)
        full = {"knn": tt.batch_knn, "knn_dot": tt.batch_knn_dot,
                "knn_cosine": tt.batch_knn_cosine}[method]
        for k in (10, 40):
            s, i = getattr(sc, method)(qs, k)
            want = full(qs, tt.VerticalBatch(rows[alive]), k)
            np.testing.assert_array_equal(i, alive[want.indices])
            assert same_bits(s, want.scores)
            assert not np.isin(i, dead).any()


class _CountOps(TorchDispatchMode):
    """Records the aten ops issued under it; ``muted`` while a K1 pass runs,
    which counts as one op, ``"k1"``."""

    def __init__(self):
        super().__init__()
        self.ops, self.muted = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.muted:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


class _CountCalls(TorchFunctionMode):
    """Records the calls into torch made from Python under it, attribute
    reads aside: each releases the interpreter lock, which a serving thread
    then waits to take back (a copy that does nothing too). ``muted`` while
    a K1 pass runs, which counts as one call, ``"k1"``."""

    def __init__(self):
        super().__init__()
        self.ops, self.muted = [], False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        if not self.muted and name != "__get__":
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


class TestHostWorkPerCall:
    """A segmented call issues its decode and merge once, not once per
    segment: outside its K1 passes it issues the same ops for 2 segments as
    for 8."""

    @staticmethod
    def ops_of_a_call(monkeypatch, n_segments: int, mode: str, counter):
        rng = np.random.default_rng(7)
        sc = tt.SegmentedCorpus(D, auto_compact=False)
        for _ in range(n_segments):
            sc.add(int_rows(rng, 40))
        sc.delete(np.arange(0, 40 * n_segments, 11))  # every segment masked
        qs = int_rows(rng, 3)
        method = MODES[mode][0]
        getattr(sc, method)(qs, 5)  # caches: norms, ids and masks on the device
        real = tk.fused_knn_keys_batch

        def one_op(*args, **kwargs):
            counter.muted = True
            try:
                return real(*args, **kwargs)
            finally:
                counter.muted = False
                counter.ops.append("k1")

        with monkeypatch.context() as patch, counter:
            patch.setattr(tk, "fused_knn_keys_batch", one_op)
            getattr(sc, method)(qs, 5)
        return counter.ops

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_ops_outside_the_k1_passes_do_not_grow_with_the_segments(self, monkeypatch, mode):
        two = self.ops_of_a_call(monkeypatch, 2, mode, _CountOps())
        eight = self.ops_of_a_call(monkeypatch, 8, mode, _CountOps())
        assert two.count("k1") == 2 and eight.count("k1") == 8
        assert [op for op in eight if op != "k1"] == [op for op in two if op != "k1"]

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_torch_calls_outside_the_k1_passes_do_not_grow_with_the_segments(self, monkeypatch,
                                                                             mode):
        two = self.ops_of_a_call(monkeypatch, 2, mode, _CountCalls())
        eight = self.ops_of_a_call(monkeypatch, 8, mode, _CountCalls())
        assert two.count("k1") == 2 and eight.count("k1") == 8
        assert [op for op in eight if op != "k1"] == [op for op in two if op != "k1"]

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_dead_rows_never_come_back_without_a_guard(self, mode):
        """A masked scan keys dead rows INT32_MIN, below any alive row's key
        (NaN included), so asking a segment for min(k, alive rows) returns
        alive rows alone: here the dead rows are the best rows and k takes
        every alive one."""
        q = np.ones(D, np.float32)
        rows = np.tile(np.arange(1, D + 1, dtype=np.float32), (12, 1))
        rows[:6] = 10.0 * q if mode == "dot" else q  # this mode's best rows, all deleted
        rows[7, 0] = np.nan
        sc = tt.SegmentedCorpus(D, auto_compact=False)
        sc.add(rows[:8])
        sc.add(rows[8:])
        assert set(range(6)) <= set(getattr(sc, MODES[mode][0])(q, 7)[1])  # the NaN row too
        sc.delete(np.arange(6))
        s, i = getattr(sc, MODES[mode][0])(q, 6)
        assert sorted(i.tolist()) == [6, 7, 8, 9, 10, 11]


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

    def test_clamped_ties_follow_k1_keys_on_every_path(self, cuda_device):
        """ROADMAP F5 on the card: K1's FMA chain rounds the near-copies'
        keys otherwise than the CPU's matmul, but every path keys them alike
        and keeps K1's order where the L2 distances clamp to 0.0."""
        rows, qs, _ = near_copy_input()
        wide = tt.batch_knn(torch.as_tensor(qs, device=cuda_device),
                            tt.VerticalBatch(torch.as_tensor(rows, device=cuda_device)), 20)
        assert int((wide.scores == 0.0).sum()) > 10
        assert_one_answer(clamped_ties_on_every_path(rows, qs, 10, cuda_device), 10)
