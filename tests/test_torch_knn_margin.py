"""The tensor-core kNN scan's gate (``csrc/knn.cu``: ``knn_scan_tc``) and
its margin (``innr_tpu_torch.kernels.knn.knn_margin``), emulated on the CPU.

The kernel scores every (row, query) pair on the tensor cores (3xTF32 for
an f32 corpus, bf16 for bf16), admits a pair when its approximate score plus
the margin T could still reach the query's current k-th best exact score,
and re-scores the admitted pairs exactly. These tests emulate the
approximate scores in float64 from the operands' 3xTF32 parts (bf16: the
operands), each
pushed by the tensor core's worst accumulation error in the direction that
hurts (the exact top-k members down, every other row up), build T from the
same pieces the kernel uses (``knn.query_terms``, ``knn_margin``, row norms
summed in float32), and check that

- the gate admits every member of ``knn_plain``'s exact top-k against the
  final k-th best score;
- a streaming emulation of the kernel (slabs of 64-row tiles, each query's
  threshold from its buffer or the k-th key another slab published,
  admitted rows offered with their exact composites, slabs merged) equals
  ``knn_plain`` bit for bit;
- a margin cut 8 times misses members on the same data, so the checks are
  not vacuous.

Data: near ties (exact duplicates, rows 1 ulp apart, a query equal to a
row), f32 rows of odd integers in [2049, 4095] whose low bit TF32 drops,
f32 operands with every low mantissa bit set (the largest low parts),
bf16 integer rows whose products and sums are exact (only the pushed
accumulation error separates the scores), Gaussian rows with NaN / +-inf /
-0.0 planted; every mode (masked forms too), D in {1, 7, 128, 130, 768}, k
in {1, 10, 257}. No tolerance: the comparisons are exact.
"""

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
    else:  # Gaussian, f32 or bf16, with non-finite rows
        rows = (rng.standard_normal((n, d)) * rng.choice([0.01, 1.0, 300.0])).astype(np.float32)
        qs = rng.standard_normal((n_q, d)).astype(np.float32)
        rows[3] = np.nan
        rows[17, 0] = np.inf
        rows[40] = -0.0
    src = rng.integers(0, n // 2, 24)
    rows[n // 2:n // 2 + 12] = rows[src[:12]]  # exact duplicates
    ulp = rows[src[12:]].copy()
    ulp[:, 0] = np.nextafter(ulp[:, 0], np.float32(np.inf))  # 1 ulp apart
    rows[n // 2 + 12:n // 2 + 24] = ulp
    qs[0] = rows[src[0]]
    dtype = torch.bfloat16 if kind in ("int16", "gauss16") else torch.float32
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

    def stream(self) -> np.ndarray:
        """The kernel's selection: per slab, tiles of 64 rows gated at the
        better of the buffer's k-th key and the best one any slab has
        published (the slabs here run in turn), admitted rows offered
        exactly; slabs merged."""
        n_q, n = self.comp.shape
        k = self.k
        out = np.empty((n_q, k), np.int64)
        for q in range(n_q):
            parts, shared = [], _INT_MIN
            for s0 in range(0, n, _SLAB):
                buf = np.full(k, _EMPTY, np.int64)
                for t0 in range(s0, min(n, s0 + _SLAB), _TILE):
                    t1 = min(n, s0 + _SLAB, t0 + _TILE)
                    shared = max(shared, int(buf[-1]) >> 32)
                    adm = self.admit(q, t0, t1, _threshold(shared, self.score))
                    cand = self.comp[q, t0:t1][adm]
                    buf = np.sort(np.concatenate([buf, cand]))[::-1][:k]
                parts.append(buf)
            out[q] = np.sort(np.concatenate(parts))[::-1][:k]
        return out


CASES = [("odd", torch.float32), ("lowbits", torch.float32), ("gauss", torch.float32),
         ("int16", torch.bfloat16), ("gauss16", torch.bfloat16)]


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

    @pytest.mark.parametrize("kind", ["lowbits", "int16"])
    def test_a_cut_margin_misses_members(self, rng, kind):
        """f32 operands whose every low mantissa bit is set, positive
        queries (the low parts at their largest), and bf16 scores that
        differ only by the pushed accumulation error: a margin 8 times
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

    def test_huge_d_admits_everything(self):
        for m in tk.knn_margin(2**24, torch.float32):
            assert m.kappa == float("inf")

    def test_rescore_stats_before_any_launch(self, monkeypatch):
        monkeypatch.setattr(tk, "_LAST_RESCORED", None)
        assert tk.rescore_stats() is None
