"""The tensor-core kNN scan's gate (``csrc/knn.cu``: ``knn_scan_tc``) and
its margin (``innr_tpu_torch.kernels.knn.knn_margin``), emulated on the CPU.

The kernel scores every (row, query) pair on the tensor cores (3xTF32 for
an f32 corpus, bf16 for bf16, bf16 for u8 codes against the query's hi/lo
bf16 split), admits a pair when its approximate score plus the margin T
could still reach the query's current k-th best exact score, and re-scores
the admitted pairs exactly. These tests emulate the approximate scores in
float64 from the operands' 3xTF32 parts (bf16: the operands; u8: the codes
and the split query's two parts), each
pushed by the tensor core's worst accumulation error in the direction that
hurts (the exact top-k members down, every other row up), build T from the
same pieces the kernel uses (``knn.query_terms``, ``knn_margin``, row norms
summed in float32), and check that

- the gate admits every member of ``knn_plain``'s exact top-k against the
  final k-th best score;
- a streaming emulation of the kernel (slabs of 64-row tiles, each query's
  threshold from its buffer's k-th key, the best k-th key another slab
  published, or the m-th best of the keys the slabs publish at rank r
  (m r >= k), on a
  slab's first tile also the k-th best of its rows' bounds s~ - T (l2:
  s~ + T) when k <= 64, admitted rows offered with their exact composites,
  slabs merged) equals ``knn_plain`` bit for bit;
- a margin cut 8 times misses members on the same data, so the checks are
  not vacuous.

Data: near ties (exact duplicates, rows 1 ulp apart, a query equal to a
row), f32 rows of odd integers in [2049, 4095] whose low bit TF32 drops,
f32 operands with every low mantissa bit set (the largest low parts),
bf16 integer rows whose products and sums are exact (only the pushed
accumulation error separates the scores), Gaussian rows with NaN / +-inf /
-0.0 planted; u8 codes with 0 and 255 planted against Gaussian queries
(24 significant bits, which the split cuts to about 16) and tiny queries
(low parts subnormal), or queries holding NaN, +-inf and -0.0; every mode
(masked forms too), D in {1, 7, 128, 130, 768}, k in {1, 10, 257}. No
tolerance: the comparisons are exact.

``TestWarpMerge`` mirrors ``topk.cuh:warp_merge`` lane by lane (the
bitonic sort across the warp, the ranks, the in-place writes highest chunk
first) against a sort of the union. ``TestU8Layout`` mirrors the u8 scan's
register layout: the A fragment each
thread builds from its 16-byte loads (codes widened to bf16 through f32),
``Tc<uint8_t>::perm_dim`` and the query staging, on a 256-dimension chunk.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.utils.order import composite_keys  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


_EMPTY = np.iinfo(np.int64).min
_INT_MIN = -(2**31)
_TILE, _SLAB = 64, 256  # the kernel's row tile; slabs of 4 tiles
MODES = ["dot", "l2", "cosine", "dotm", "l2m", "cosinem"]


def _tf32(a):
    """float32 values as the tensor core reads them: the low 13 mantissa
    bits dropped (truncation)."""
    return (np.ascontiguousarray(a, np.float32).view(np.int32) & ~0x1FFF).view(np.float32)


def _bf16(a):
    """float32 values rounded to bf16 (to nearest, ties to even, on the
    float32 bits), as float32; NaN stays NaN."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    return np.where(np.isnan(a), a, rounded.view(np.float32)).astype(np.float32)


def _split(q):
    """The u8 scan's query parts: q_hi = bf16(q), q_lo = bf16(q - q_hi), 0
    where q is not finite (innr_tpu/kernels/knn.py's split)."""
    q = np.asarray(q, np.float32)
    hi = _bf16(q)
    with np.errstate(invalid="ignore"):
        lo = np.where(np.isfinite(q), _bf16(q - hi), np.float32(0.0))
    return hi, lo.astype(np.float32)


def _threshold(key: int, score: int) -> np.float32:
    """csrc/knn.cu:threshold: the exact score a k-th key stands for, or
    +-inf (open) while it is INT_MIN."""
    if key == _INT_MIN:
        return np.float32(np.inf if score == 1 else -np.inf)
    tkey = ~key if score == 1 else key
    bits = tkey ^ (0x7FFFFFFF if tkey < 0 else 0)
    return np.array([bits], np.int32).view(np.float32)[0]


def _data(rng, kind: str, n: int, d: int, n_q: int):
    """(rows as a torch tensor of the corpus dtype, float32 queries)."""
    if kind == "odd":  # f32: exact dots, inexact TF32 rows
        rows = (2 * rng.integers(1024, 2048, (n, d)) + 1).astype(np.float32)
        qs = rng.integers(-8, 9, (n_q, d)).astype(np.float32)
    elif kind == "lowbits":  # f32: every low mantissa bit set, the largest low parts
        def worst(shape):
            v = 1.0 + 2.0**-10 * rng.integers(0, 1024, shape) + (2.0**-10 - 2.0**-23)
            return (v * 2.0 ** rng.integers(-3, 4, shape)).astype(np.float32)

        rows, qs = worst((n, d)), worst((n_q, d))
    elif kind == "int16":  # bf16: exact products and sums
        rows = rng.integers(-255, 256, (n, d)).astype(np.float32)
        qs = rng.integers(-8, 9, (n_q, d)).astype(np.float32)
    elif kind in ("codes", "codes_nonfinite"):  # u8
        rows = rng.integers(0, 256, (n, d)).astype(np.float32)
        rows[5], rows[6], rows[7, ::2] = 0, 255, 255
        qs = rng.standard_normal((n_q, d)).astype(np.float32)
        qs[1] *= np.float32(1e-37)  # low parts subnormal or flushed
        if kind == "codes_nonfinite":
            qs[1, 0] = np.nan
            qs[2, ::3] = -0.0
            qs[2, min(1, d - 1)] = -np.inf
    else:  # Gaussian, f32 or bf16, with non-finite rows
        rows = (rng.standard_normal((n, d)) * rng.choice([0.01, 1.0, 300.0])).astype(np.float32)
        qs = rng.standard_normal((n_q, d)).astype(np.float32)
        rows[3] = np.nan
        rows[17, 0] = np.inf
        rows[40] = -0.0
    src = rng.integers(0, n // 2, 24)
    rows[n // 2:n // 2 + 12] = rows[src[:12]]  # exact duplicates
    ulp = rows[src[12:]].copy()
    if kind.startswith("codes"):  # one code apart
        ulp[:, 0] = np.where(ulp[:, 0] < 255, ulp[:, 0] + 1, 254)
    else:
        ulp[:, 0] = np.nextafter(ulp[:, 0], np.float32(np.inf))  # 1 ulp apart
    rows[n // 2 + 12:n // 2 + 24] = ulp
    qs[0] = rows[src[0]]
    dtype = {"int16": torch.bfloat16, "gauss16": torch.bfloat16, "codes": torch.uint8,
             "codes_nonfinite": torch.uint8}.get(kind, torch.float32)
    return torch.from_numpy(rows).to(dtype), torch.from_numpy(qs)


def _aux(rng, rows, mode: str):
    n = rows.shape[0]
    norms2, inv = tk._norms2(rows), tk.inv_norms(rows)
    mask = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32))
    return {"dot": None, "l2": norms2, "cosine": inv, "dotm": mask,
            "l2m": torch.stack([norms2, mask]), "cosinem": torch.stack([inv, mask])}[mode]


class Gate:
    """The kernel's gate inputs for one launch: each pair's approximate
    score s~ and margin T (float32), each row's predicate; the exact
    composites and ``knn_plain``'s top-k."""

    def __init__(self, qs, rows, aux, mode: str, k: int, cut: float = 1.0):
        score, _ = tk._MODES[mode]
        vals, mask = tk._split_aux(aux, mode, rows.shape[0])
        self.score, self.k = score, k
        self.comp = tk._plain_composites(qs, rows, vals, mask, mode).numpy()
        self.top = composite_keys(*tk.knn_plain(qs, rows, aux, k, mode)).numpy()
        members = np.zeros(self.comp.shape, bool)
        for q in range(self.comp.shape[0]):
            members[q] = np.isin(self.comp[q], self.top[q])
        d = rows.shape[1]
        x = rows.float().numpy()
        bf16 = rows.dtype == torch.bfloat16
        q = qs.to(torch.bfloat16).float().numpy() if bf16 else qs.numpy()
        a = np.zeros(x.shape[0], np.float32) if vals is None else vals.numpy()
        with np.errstate(all="ignore"):
            if bf16:  # exact products
                parts = [(q, x)]
            elif rows.dtype == torch.uint8:  # exact products of codes and both parts
                parts = [(part, x) for part in _split(q)]
            else:  # 3xTF32: x_hi q_hi + x_hi q_lo + x_lo q_hi, low parts truncated
                x_hi, q_hi = _tf32(x), _tf32(q)
                parts = [(q_hi, x_hi), (_tf32(q - q_hi), x_hi), (q_hi, _tf32(x - x_hi))]
            dot = sum(qp.astype(np.float64) @ xp.astype(np.float64).T for qp, xp in parts)
            p = sum(np.abs(qp).astype(np.float64) @ np.abs(xp).astype(np.float64).T
                    for qp, xp in parts)
            err = 2 * (len(parts) * d + 16) * 2.0**-23 * (1 + 2.0**-8) * p
            dt = (dot + np.where(members, -err, err)).astype(np.float32)
            if score == 1:
                st = (a[None, :].astype(np.float64) - 2.0 * dt).astype(np.float32)
            elif score == 2:
                st = dt * a[None, :]
            else:
                st = dt
            m = tk.knn_margin(d, rows.dtype)[score]
            kq = tk.query_terms(qs, rows.dtype, score).numpy()
            rn2 = (x * x).sum(axis=1, dtype=np.float32)
            xn = np.where(rn2 < np.float32(2.0**100),
                          np.sqrt(rn2) + np.float32(2.0**-59), np.float32(np.inf))
            rowf = np.abs(a) if score == 2 else np.ones_like(a)
            kx = (xn * rowf).astype(np.float32)
            cx = (m.aux * np.abs(a).astype(np.float64) + m.abs * rowf).astype(np.float32)
            t = (kq[:, None].astype(np.float64) * kx[None, :] + cx[None, :]).astype(np.float32)
        self.st, self.t = st, (t / np.float32(cut)).astype(np.float32)
        self.passing = np.ones(x.shape[0], bool) if mask is None else mask.numpy() > 0

    def admit(self, q: int, lo: int, hi: int, thr: np.float32) -> np.ndarray:
        """The rows [lo, hi) of query q the kernel re-scores (or, failing
        the predicate, offers with an INT_MIN key) at threshold thr."""
        st, t = self.st[q, lo:hi], self.t[q, lo:hi]
        with np.errstate(all="ignore"):
            if self.score == 1:
                ok = ~((st - t) > thr)
            else:
                ok = ~((st + t) < thr)
        is_open = thr == np.float32(np.inf if self.score == 1 else -np.inf)
        return np.where(self.passing[lo:hi], ok, is_open)

    def members_admitted(self) -> bool:
        """Every top-k member passes the gate at the final k-th best."""
        for q in range(self.comp.shape[0]):
            thr = _threshold(int(self.top[q, -1]) >> 32, self.score)
            adm = self.admit(q, 0, self.comp.shape[1], thr)
            if not adm[np.isin(self.comp[q], self.top[q])].all():
                return False
        return True

    def tile_bound(self, q: int, lo: int, hi: int) -> np.float32:
        """csrc/knn.cu's first-tile threshold: the k-th best of the passing
        rows' s~ - T (l2: the k-th smallest s~ + T), or the open threshold
        when k > 64 or fewer than k rows have one."""
        st, t = self.st[q, lo:hi], self.t[q, lo:hi]
        with np.errstate(all="ignore"):
            b = -(st + t) if self.score == 1 else st - t
        b = np.where(self.passing[lo:hi] & ~np.isnan(b), b, np.float32(-np.inf))
        kth = np.sort(b)[::-1][self.k - 1] if self.k <= min(_TILE, b.size) else -np.inf
        if kth == -np.inf:
            return np.float32(np.inf if self.score == 1 else -np.inf)
        return np.float32(-kth if self.score == 1 else kth)

    def better(self, a: np.float32, b: np.float32) -> np.float32:
        return min(a, b) if self.score == 1 else max(a, b)

    def stream(self) -> np.ndarray:
        """The kernel's selection: per slab, tiles of 64 rows gated at the
        better of the buffer's k-th key and the best one any slab has
        published (the slabs here run in turn), and on the slab's first
        tile the tile's bound; admitted rows offered exactly; slabs
        merged."""
        n_q, n = self.comp.shape
        k, n_slabs = self.k, -(-n // _SLAB)
        r = min(k, max(1, -(-2 * k // n_slabs)))  # each slab publishes its key at rank r
        m = -(-k // r)
        out = np.empty((n_q, k), np.int64)
        for q in range(n_q):
            parts, shared, pub = [], _INT_MIN, [_INT_MIN] * n_slabs
            for s0 in range(0, n, _SLAB):
                buf = np.full(k, _EMPTY, np.int64)
                for t0 in range(s0, min(n, s0 + _SLAB), _TILE):
                    t1 = min(n, s0 + _SLAB, t0 + _TILE)
                    # A key k rows reach: this buffer's k-th, or the m-th best
                    # key the slabs published (m slabs with r rows each).
                    pub[s0 // _SLAB] = int(buf[r - 1]) >> 32
                    shared = max(shared, int(buf[-1]) >> 32, sorted(pub)[::-1][m - 1])
                    thr = _threshold(shared, self.score)
                    if t0 == s0:
                        thr = self.better(thr, self.tile_bound(q, t0, t1))
                    adm = self.admit(q, t0, t1, thr)
                    cand = self.comp[q, t0:t1][adm]
                    buf = np.sort(np.concatenate([buf, cand]))[::-1][:k]
                parts.append(buf)
            out[q] = np.sort(np.concatenate(parts))[::-1][:k]
        return out


CASES = [("odd", torch.float32), ("lowbits", torch.float32), ("gauss", torch.float32),
         ("int16", torch.bfloat16), ("gauss16", torch.bfloat16), ("codes", torch.uint8),
         ("codes_nonfinite", torch.uint8)]


class TestGate:
    @pytest.mark.parametrize("kind", [c[0] for c in CASES])
    @pytest.mark.parametrize("d", [1, 7, 128, 130, 768])
    @pytest.mark.parametrize("k", [1, 10, 257])
    @pytest.mark.parametrize("mode", MODES)
    def test_members_admitted_and_stream_equals_plain(self, rng, kind, d, k, mode):
        rows, qs = _data(rng, kind, 640, d, 3)
        if mode.startswith("cos"):
            qs = tk._unit_queries(qs)
        gate = Gate(qs, rows, _aux(rng, rows, mode), mode, k)
        assert gate.members_admitted()
        np.testing.assert_array_equal(gate.stream(), gate.top)

    @pytest.mark.parametrize("kind", ["lowbits", "int16", "codes"])
    def test_a_cut_margin_misses_members(self, rng, kind):
        """f32 operands whose every low mantissa bit is set, positive
        queries (the low parts at their largest), and bf16 scores, or u8
        codes against positive queries, that differ only by the pushed
        accumulation error (and the split's residue): a margin 8 times
        smaller than knn_margin's then drops exact members."""
        missed = 0
        for d in (1, 7, 128):
            rows, qs = _data(rng, kind, 640, d, 3)
            qs = qs.abs() + 1.0
            for mode in MODES:
                gate = Gate(qs, rows, _aux(rng, rows, mode), mode, 10, cut=8.0)
                missed += not gate.members_admitted()
                missed += not np.array_equal(gate.stream(), gate.top)
        assert missed > 0


class TestMargin:
    def test_grows_with_d_and_stays_small(self):
        for dtype in (torch.float32, torch.bfloat16):
            small, big = tk.knn_margin(8, dtype), tk.knn_margin(4096, dtype)
            for s in range(3):
                assert 0 < small[s].kappa < big[s].kappa < 0.03
                assert 0 < small[s].abs < big[s].abs < 1e-17
            assert small[1].aux == big[1].aux == 4 * 2.0**-24
            assert small[0].aux == small[2].aux == 0.0

    def test_bf16_margin_below_tf32(self):
        """bf16 products are exact; 3xTF32 keeps about 3 2^-20 of each
        product and sums three times as many."""
        for d in (1, 128, 768):
            f32, bf16 = tk.knn_margin(d, torch.float32), tk.knn_margin(d, torch.bfloat16)
            for s in range(3):
                assert bf16[s].kappa < f32[s].kappa
            assert f32[0].kappa > 2 * 3 * 2.0**-20

    def test_l2_margin_is_about_twice_dot(self):
        m = tk.knn_margin(128, torch.float32)
        assert 2 * m[0].kappa <= m[1].kappa < 2.1 * m[0].kappa
        assert m[1].abs == 2 * m[0].abs

    def test_query_terms_irregular_queries_always_rescored(self):
        qs = torch.tensor([[1.0, 2.0], [np.nan, 0.0], [np.inf, 1.0], [2.0**51, 0.0],
                           [0.0, 0.0]], dtype=torch.float32)
        kq = tk.query_terms(qs, torch.float32, 0)
        assert kq.dtype == torch.float32
        assert torch.isinf(kq[1:4]).all()
        kappa = tk.knn_margin(2, torch.float32)[0].kappa
        assert float(kq[0]) == pytest.approx(kappa * 5**0.5, rel=1e-6)
        assert 0 < float(kq[4]) < 1e-15  # the underflow slack only

    def test_query_terms_bf16_rounds_first(self):
        qs = torch.tensor([[1.0 + 2.0**-12, 0.0]], dtype=torch.float32)
        k16 = tk.query_terms(qs, torch.bfloat16, 0)
        assert float(k16[0]) == pytest.approx(tk.knn_margin(2, torch.bfloat16)[0].kappa, rel=1e-6)

    def test_u8_margin_covers_the_split(self):
        """Two bf16 products per pair and dimension, and the split's residue
        of up to 2^-16 per product: above bf16's margin, and at least twice
        the residue (the safety factor)."""
        for d in (1, 128, 768):
            u8, bf16 = tk.knn_margin(d, torch.uint8), tk.knn_margin(d, torch.bfloat16)
            for s in range(3):
                assert bf16[s].kappa < u8[s].kappa < 0.03
                assert u8[s].abs == bf16[s].abs and u8[s].aux == bf16[s].aux
            assert u8[0].kappa > 2 * 2.0**-16

    def test_split_residue_within_2_to_the_minus_16(self, rng):
        """q_hi + q_lo is within 2^-16 |q| of q, and both parts are bf16."""
        q = (rng.standard_normal(100_000) * 2.0 ** rng.integers(-60, 60, 100_000)).astype(
            np.float32)
        hi, lo = _split(q)
        for part in (hi, lo):
            assert (part.view(np.uint32) & 0xFFFF == 0).all()
        res = np.abs(q.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
        assert (res <= 2.0**-16 * np.abs(q.astype(np.float64))).all()
        assert res.max() > 0  # the split drops bits of 24-bit queries

    def test_bf16_rounding_matches_torch(self, rng):
        q = np.concatenate([rng.standard_normal(10_000).astype(np.float32),
                            np.array([np.inf, -np.inf, -0.0, 3.4e38, 1e-40, 1 + 2.0**-8,
                                      1 + 3 * 2.0**-8], np.float32)])
        want = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(_bf16(q).view(np.uint32), want.view(np.uint32))

    def test_query_terms_u8_takes_the_query_as_is(self):
        qs = torch.tensor([[1.0 + 2.0**-12, 0.0], [np.inf, 0.0]], dtype=torch.float32)
        k8 = tk.query_terms(qs, torch.uint8, 0)
        kappa = tk.knn_margin(2, torch.uint8)[0].kappa
        assert float(k8[0]) == pytest.approx(kappa * (1.0 + 2.0**-12), rel=1e-7)
        assert torch.isinf(k8[1])

    def test_huge_d_admits_everything(self):
        for m in tk.knn_margin(2**24, torch.float32):
            assert m.kappa == float("inf")

    def test_rescore_stats_before_any_launch(self, monkeypatch):
        monkeypatch.setattr(tk, "_THIS_THREAD", threading.local())
        assert tk.rescore_stats() is None


def _fma32(x, y, z):
    """fmaf on float32 arrays: the product is exact in float64, one sum and
    the final rounding (a model of the card's fmaf, odd with the sign)."""
    with np.errstate(all="ignore"):
        return (x.astype(np.float64) * y.astype(np.float64) + z.astype(np.float64)).astype(
            np.float32)


class TestAdmissionForm:
    """csrc/knn.cu:gate admits every register without a branch, in terms
    where larger is better for every mode (l2's score and threshold
    negated); it admits exactly the pairs of the per-mode form it replaced,
    NaN, infinities and signed zeros included."""

    @staticmethod
    def _values(rng, n):
        v = rng.standard_normal(n).astype(np.float32) * np.float32(4)
        special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 3e38, -3e38, 1e-40], np.float32)
        v[rng.integers(0, n, n // 8)] = rng.choice(special, n // 8)
        return v

    @pytest.mark.parametrize("score", [0, 1, 2])
    def test_negated_terms_admit_the_same_pairs(self, rng, score):
        n = 20_000
        acc, a, kq, kx, cx, thr = (self._values(rng, n) for _ in range(6))
        thr[rng.integers(0, n, n // 8)] = np.float32(np.inf if score == 1 else -np.inf)  # open
        passing = rng.random(n) < 0.8
        open_ = np.float32(np.inf if score == 1 else -np.inf)
        with np.errstate(all="ignore"):
            tb = _fma32(kq, kx, cx)
            # the per-mode form
            sv = {0: acc, 1: _fma32(np.full(n, -2, np.float32), acc, a), 2: acc * a}[score]
            old = ~((sv - tb) > thr) if score == 1 else ~((sv + tb) < thr)
            old = np.where(passing, old, thr == open_)
            # the branch-free form
            mul = {0: np.ones(n, np.float32), 1: np.full(n, 2, np.float32), 2: a}[score]
            add = -a if score == 1 else np.zeros(n, np.float32)
            tp = -thr if score == 1 else thr
            new = np.where(passing, ~((_fma32(acc, mul, add) + tb) < tp), tp == -np.inf)
        np.testing.assert_array_equal(new, old)

    def test_register_masks_cover_rows_and_columns(self):
        """Entry j's registers are bits 5 << (4 (j / 2) + j % 2), row h's
        the pattern 0x3 << 2 h of every nibble."""
        for j in range(16):
            regs = {i for i in range(32) if 2 * (i >> 2) + (i & 1) == j}
            assert sum(1 << i for i in regs) == 5 << (4 * (j >> 1) + (j & 1))
        for h, mask in ((0, 0x33333333), (1, 0xCCCCCCCC)):
            assert sum(1 << i for i in range(32) if (i >> 1) & 1 == h) == mask


def _u8_perm_dim(kk: int) -> int:
    """csrc/knn.cu: Tc<uint8_t>::perm_dim."""
    s, q = kk >> 4, kk & 15
    return 64 * (s >> 2) + 16 * ((q & 7) >> 1) + 4 * (s & 3) + (q & 1) + 2 * (q >> 3)


def _codes_bf16x2(w: int, h: int) -> int:
    """csrc/knn.cu: codes_bf16x2, on the bits: byte permutes into the f32
    2^23 + c, minus 2^23 in float32, the top halves packed."""
    def perm(x, y, sel):
        pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
        return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))

    def code_f32(sel):
        bits = np.array([perm(w, 0x4B000000, sel)], np.uint32)
        return int((bits.view(np.float32) - np.float32(2.0**23)).view(np.uint32)[0])

    return perm(code_f32(0x7440 + 2 * h), code_f32(0x7441 + 2 * h), 0x7632)


class TestU8Layout:
    """The u8 scan's registers and staging, on one 256-dimension chunk of a
    64-row tile: mma.cuh's A fragment (thread t holds rows 16 (t / 32) +
    (t % 32) / 4 and + 8; a0 / a1 the k positions 2 (t % 4) and + 1, a2 /
    a3 those + 8, a bf16x2 word each), load_rows' vectors (quad thread t %
    4 takes 16 codes at 16 (t % 4) + 64 j), the query staging (K-major
    bf16, 8 per 16-byte column chunk, k positions permuted as perm_dim) and
    the B descriptor of k-step s (base + 2 NQ 16 s bytes, leading offset NQ
    16 bytes)."""

    CHUNK, NQ = 256, 8

    def test_perm_dim_is_a_bijection_of_the_chunk(self):
        dims = [_u8_perm_dim(kk) for kk in range(self.CHUNK)]
        assert sorted(dims) == list(range(self.CHUNK))

    def test_widening_is_exact_for_every_code(self):
        codes = np.arange(256)
        want = torch.from_numpy(codes.astype(np.float32)).to(torch.bfloat16).view(
            torch.int16).numpy().astype(np.uint16)
        for c0 in range(0, 256, 4):
            w = int(c0 | (c0 + 1) << 8 | (c0 + 2) << 16 | (c0 + 3) << 24)
            for h in (0, 1):
                got = _codes_bf16x2(w, h)
                assert got & 0xFFFF == want[c0 + 2 * h]
                assert got >> 16 == want[c0 + 2 * h + 1]

    def test_a_fragment_and_query_staging_meet_dimension_for_dimension(self, rng):
        """The tensor core's product over the chunk pairs row dimension i
        with query dimension i, for every k-step, thread and register."""
        x = rng.integers(0, 256, (64, self.CHUNK)).astype(np.uint8)
        q = rng.standard_normal((self.NQ, self.CHUNK)).astype(np.float32)
        # A (64 x 256 k positions) as the threads' registers supply it.
        a = np.full((64, self.CHUNK), -1.0)
        for t in range(128):
            g, quad = 16 * (t // 32) + (t % 32) // 4, t % 4
            vec = [[x[g + 8 * h, 16 * quad + 64 * j:16 * quad + 64 * j + 16] for j in range(4)]
                   for h in (0, 1)]
            for st in range(16):
                words = [int.from_bytes(vec[h][st >> 2][4 * (st & 3):4 * (st & 3) + 4].tobytes(),
                                        "little") for h in (0, 1)]
                regs = [_codes_bf16x2(words[0], 0), _codes_bf16x2(words[1], 0),
                        _codes_bf16x2(words[0], 1), _codes_bf16x2(words[1], 1)]
                for r, reg in enumerate(regs):
                    row, k0 = g + 8 * (r & 1), 16 * st + 2 * quad + 8 * (r >> 1)
                    for e in (0, 1):
                        half = np.array([(reg >> (16 * e)) & 0xFFFF], np.uint16)
                        a[row, k0 + e] = torch.from_numpy(half.view(np.int16)).view(
                            torch.bfloat16).float().item()
        perm = np.array([_u8_perm_dim(kk) for kk in range(self.CHUNK)])
        np.testing.assert_array_equal(a, x[:, perm].astype(np.float64))
        # B: stage_queries' K-major buffer, read through each step's descriptor.
        for part in _split(q):
            buf = np.full(self.NQ * self.CHUNK, np.nan, np.float32)
            for r in range(self.NQ):
                for kk in range(self.CHUNK):
                    buf[(kk // 8) * self.NQ * 8 + r * 8 + kk % 8] = part[r, perm[kk]]
            b = np.empty((self.NQ, self.CHUNK), np.float32)
            for st in range(16):
                for kp in range(16):
                    at = st * 2 * self.NQ * 8 + (kp // 8) * self.NQ * 8 + np.arange(self.NQ) * 8
                    b[:, 16 * st + kp] = buf[at + kp % 8]
            np.testing.assert_array_equal(b, part[:, perm])

    def test_word_loads_equal_vector_loads(self, rng):
        """Rows whose D is not a multiple of 16: Tc<uint8_t>::word_of packs
        four codes from col, zeros past d, the bytes a 16-byte load of the
        zero-padded row would give."""
        for d in (1, 7, 127, 130):
            row = rng.integers(0, 256, d).astype(np.uint8)
            padded = np.zeros(-(-d // 256) * 256, np.uint8)
            padded[:d] = row
            for col in range(0, padded.size, 4):
                word = sum(int(row[col + b]) << (8 * b) for b in range(4) if col + b < d)
                assert word == int.from_bytes(padded[col:col + 4].tobytes(), "little")


def _warp_merge(buf, cand):
    """csrc/topk.cuh: warp_merge of one candidate per lane (32) into the
    sorted buffer ``buf`` (k,), step by step as the warp runs it."""
    buf, k, lanes = buf.copy(), buf.size, np.arange(32)
    c = np.where(cand > buf[-1], cand, _EMPTY)
    live = c != _EMPTY
    if not live.any():
        return buf
    if live.sum() == 1:  # warp_insert
        return np.sort(np.append(buf, c[live]))[::-1][:k]
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            o = c[lanes ^ stride]
            keep_max = ((lanes & stride) == 0) == ((lanes & size) == 0)
            c = np.where(keep_max, np.maximum(c, o), np.minimum(c, o))
            stride //= 2
        size *= 2
    rank = np.full(32, k)
    for lane in lanes[c != _EMPTY]:
        lo, hi = 0, k
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (mid + 1, hi) if buf[mid] > c[lane] else (lo, mid)
        rank[lane] = lane + lo
    for base in range((k - 1) // 32 * 32, -1, -32):
        j = base + lanes
        v = np.where(j < k, buf[np.minimum(j, k - 1)], _EMPTY)
        above = np.zeros(32, int)
        for step in (16, 8, 4, 2, 1):
            above = np.where(c[above + step - 1] > v, above + step, above)
        above = np.where(c[above] > v, above + 1, above)
        for lane in lanes[(j < k) & (j + above < k)]:
            buf[j[lane] + above[lane]] = v[lane]
    for lane in lanes[rank < k]:
        buf[rank[lane]] = c[lane]
    return buf


class TestWarpMerge:
    @pytest.mark.parametrize("k", [1, 2, 10, 32, 33, 80, 256])
    @pytest.mark.parametrize("n_live", [0, 1, 2, 7, 32])
    def test_merge_equals_the_top_k_of_the_union(self, rng, k, n_live):
        for fill in (k, k // 2):  # a full buffer, and one with empty slots
            pool = rng.choice(2**62, 4 * k + 64, replace=False).astype(np.int64)
            buf = np.full(k, _EMPTY, np.int64)
            buf[:fill] = np.sort(pool[:fill])[::-1]
            cand = np.full(32, _EMPTY, np.int64)
            lanes = rng.choice(32, n_live, replace=False)
            cand[lanes] = pool[k:k + n_live]
            if n_live > 2:
                cand[lanes[0]] = -(2**62)  # below the buffer's k-th when it is full
            want = np.sort(np.concatenate([buf, cand]))[::-1][:k]
            np.testing.assert_array_equal(_warp_merge(buf, cand), want)
