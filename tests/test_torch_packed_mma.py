"""The packed scan's design in ``csrc/packed_knn.cu``, emulated on the CPU.

A CUDA kernel cannot run here, so these tests rebuild its arithmetic and
its selection in numpy / torch and hold them to the plain version
(``utils.bits.word_scores``, ``kernels.packed_knn.packed_knn_plain``) and
to the JAX package:

- the b1 tensor-core products of one CTA tile, register by register: the
  16-byte row loads of thread (g, t), the A / B fragments of
  ``mma.m16n8k256.b1.and.popc``, the k-steps of 256 bits in chunks of 3,
  zero-padded, popc(x) as a product against an all-ones column, and the
  accumulator-to-(row, query) map of the epilogue;
- the same for ternary, on overlapping planes, as two sums over both
  planes;
- the warp's bitonic sort and merge-path merge, and ``packed_merge``'s
  histogram cut;
- the gate and the slabs' streaming selection: thresholds own k-th + 1 or
  the best published k-th key, pools merged once enough pairs are pending
  or one pool holds 128, the exclusion bound, then the merge above the
  published floor;
- the tiling helper, pinned;
- ``packed_knn_plain`` against JAX's ``fused_ternary_knn_batch`` on
  overlapping planes (interpret mode).

Words are drawn over all 32 bits (the sign bit of the int32 view included).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from innr_tpu.kernels import packed_knn as jpk  # noqa: E402
from innr_tpu_torch import config as itt_config  # noqa: E402
from innr_tpu_torch.kernels import packed_knn as tpk  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402
from innr_tpu_torch.utils.bits import word_scores  # noqa: E402
from innr_tpu_torch.utils.bits import words_from_numpy as T  # noqa: E402
from innr_tpu_torch.utils.order import composite_keys, split_composite  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = itt_config.set_default_device("cpu")
    yield
    itt_config.set_default_device(previous)


ALL_ONES = np.uint32(0xFFFFFFFF)
TILE_ROWS, CHUNK_STEPS = 128, 3
INT64_MIN = np.iinfo(np.int64).min


def words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def popc(x):
    return np.bitwise_count(np.asarray(x, dtype=np.uint32)).astype(np.int64)


def mma_b1(acc, a, b):
    """One warp's ``mma.m16n8k256.row.col.s32.b1.b1.s32.and.popc``: ``a``
    (32, 4) and ``b`` (32, 2) per-lane registers, ``acc`` (32, 4). A row g
    holds the a0 words of lanes (g, 0..3) then their a2 words, row g + 8
    their a1 / a3; B column g the b0 then the b1 words of lanes (g, 0..3);
    lane (g, t) receives D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]."""
    a4 = a.reshape(8, 4, 4)  # [g][t][register]
    b4 = b.reshape(8, 4, 2)
    rows = np.concatenate([np.concatenate([a4[:, :, 0], a4[:, :, 2]], axis=1),
                           np.concatenate([a4[:, :, 1], a4[:, :, 3]], axis=1)])  # (16, 8)
    cols = np.concatenate([b4[:, :, 0], b4[:, :, 1]], axis=1)  # (8, 8)
    d = popc(rows[:, None, :] & cols[None, :, :]).sum(axis=2)  # (16, 8)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    return acc + np.stack([d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t], d[g + 8, 2 * t + 1]],
                          axis=1)


def emulate_tile(planes, queries, n_rows):
    """The keys one CTA tile's epilogue sees: ``planes`` (1 or 2) corpus
    planes (n_rows <= 128, W) uint32, ``queries`` the matching (NQ, W) query
    planes, NQ a multiple of 8. Returns (128, NQ) int64 keys (``-count`` or
    the dot; rows past n_rows are the kernel's zero rows) and how many
    registers mapped to each (row, query)."""
    nq, w = queries[0].shape
    steps = -(-w // 8)
    nb_count = nq // 8
    pad = [np.zeros((TILE_ROWS, 8 * steps + 8), np.uint32) for _ in planes]
    for p, src in zip(pad, planes):
        p[:n_rows, :w] = src
    qpad = [np.zeros((nq, 8 * steps + 8), np.uint32) for _ in queries]
    for p, src in zip(qpad, queries):
        p[:, :w] = src
    binary = len(planes) == 1
    keys = np.zeros((TILE_ROWS, nq), np.int64)
    hits = np.zeros((TILE_ROWS, nq), np.int64)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    pq = popc(queries[0]).sum(axis=1) if binary else np.zeros(nq, np.int64)
    for warp in range(4):
        r0 = 32 * warp + 4 * g  # each lane's 4 rows
        acc = np.zeros((nb_count, 2, 32, 4), np.int64)
        opp = np.zeros_like(acc)
        px = np.zeros((2, 32, 4), np.int64)
        cpp = -(-steps // CHUNK_STEPS)
        for ch in range(len(planes) * cpp):  # items: a plane's chunk of k-steps
            plane, s0 = ch // cpp, (ch % cpp) * CHUNK_STEPS
            for s in range(s0, min(steps, s0 + CHUNK_STEPS)):
                # 16-byte loads: word 8 s + t and 8 s + 4 + t of rows r0..r0+3
                v0 = np.stack([pad[plane][r0 + j, 8 * s + t] for j in range(4)], axis=1)
                v1 = np.stack([pad[plane][r0 + j, 8 * s + 4 + t] for j in range(4)], axis=1)
                for h in range(2):
                    a = np.stack([v0[:, 2 * h], v0[:, 2 * h + 1], v1[:, 2 * h], v1[:, 2 * h + 1]],
                                 axis=1)
                    for nb in range(nb_count):
                        q = 8 * nb + g
                        b_same = np.stack([qpad[plane][q, 8 * s + t],
                                           qpad[plane][q, 8 * s + 4 + t]], axis=1)
                        acc[nb, h] = mma_b1(acc[nb, h], a, b_same)
                        if not binary:
                            b_opp = np.stack([qpad[1 - plane][q, 8 * s + t],
                                              qpad[1 - plane][q, 8 * s + 4 + t]], axis=1)
                            opp[nb, h] = mma_b1(opp[nb, h], a, b_opp)
                    if binary:
                        ones = np.full((32, 2), ALL_ONES, np.uint32)
                        px[h] = mma_b1(px[h], a, ones)
        for nb in range(nb_count):
            for h in range(2):
                for e in range(4):
                    row = r0 + 2 * h + e // 2
                    col = 8 * nb + 2 * t + (e & 1)
                    if binary:
                        key = 2 * acc[nb, h, :, e] - px[h, :, e] - pq[col]
                    else:
                        key = acc[nb, h, :, e] - opp[nb, h, :, e]
                    keys[row, col] = key
                    hits[row, col] += 1
    return keys, hits


def special_rows(rows):
    """Rows 0-1 all zero, 2-3 all ones (both planes: overlapping)."""
    rows = rows.copy()
    rows[0:2] = 0
    rows[2:4] = ALL_ONES
    return rows


class TestTileArithmetic:
    @pytest.mark.parametrize("w", [1, 3, 9, 24, 64])
    @pytest.mark.parametrize("nq,n_rows", [(8, 128), (16, 77)])
    def test_binary_products_equal_word_scores(self, rng, w, nq, n_rows):
        rows = special_rows(words(rng, (n_rows, w)))
        qs = words(rng, (nq, w))
        qs[1] = ALL_ONES
        keys, hits = emulate_tile([rows], [qs], n_rows)
        assert (hits == 1).all()  # every (row, query) in exactly one register
        want = word_scores((T(qs)[:, None, :],), (T(rows)[None],)).sum(dim=2).T
        np.testing.assert_array_equal(-keys[:n_rows], want.numpy())

    @pytest.mark.parametrize("w", [1, 3, 9, 24, 64])
    @pytest.mark.parametrize("nq,n_rows", [(8, 128), (16, 77)])
    def test_ternary_products_on_overlapping_planes(self, rng, w, nq, n_rows):
        pos, neg = (special_rows(words(rng, (n_rows, w))) for _ in range(2))
        qp, qn = words(rng, (nq, w)), words(rng, (nq, w))  # overlap too
        qp[1] = qn[1] = ALL_ONES
        keys, hits = emulate_tile([pos, neg], [qp, qn], n_rows)
        assert (hits == 1).all()
        assert ((pos & neg) != 0).any() and ((qp & qn) != 0).any()
        want = word_scores((T(qp)[:, None, :], T(qn)[:, None, :]),
                           (T(pos)[None], T(neg)[None])).sum(dim=2).T
        np.testing.assert_array_equal(keys[:n_rows], want.numpy())

    def test_identity_needs_no_disjoint_planes(self, rng):
        """popc((p&a)|(n&b)) - popc((p&b)|(n&a)) equals the four-product sum
        on every word, overlapping planes included."""
        p, n, a, b = (words(rng, 20_000) for _ in range(4))
        lhs = popc((p & a) | (n & b)) - popc((p & b) | (n & a))
        rhs = popc(p & a) + popc(n & b) - popc(p & b) - popc(n & a)
        np.testing.assert_array_equal(lhs, rhs)
        np.testing.assert_array_equal(popc(p ^ a), popc(p) + popc(a) - 2 * popc(p & a))


def warp_sort_desc(cand):
    """csrc/packed_knn.cu:warp_sort_desc: bitonic, padded with INT64_MIN."""
    size = 1
    while size < len(cand):
        size *= 2
    c = np.full(size, INT64_MIN, np.int64)
    c[:len(cand)] = cand
    span = 2
    while span <= size:
        stride = span // 2
        while stride > 0:
            for i in range(size // 2):
                lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1))
                hi = lo + stride
                if (c[lo] < c[hi]) == ((lo & span) == 0):
                    c[lo], c[hi] = c[hi], c[lo]
            stride //= 2
        span *= 2
    return c


def warp_merge_desc(buf, cand):
    """csrc/packed_knn.cu:warp_merge_desc: lane l finds output l seg on the
    merge path by a binary search and merges seg outputs."""
    k, m = len(buf), len(cand)
    seg = -(-k // 32)
    out = np.empty(k, np.int64)
    for lane in range(32):
        d = lane * seg
        if d >= k:
            continue
        lo, hi = max(0, d - m), min(d, k)
        while lo < hi:
            mid = (lo + hi) // 2
            if buf[mid] > cand[d - mid - 1]:
                lo = mid + 1
            else:
                hi = mid
        ia, ib = lo, d - lo
        for o in range(d, min(k, d + seg)):
            if ib >= m or (ia < k and buf[ia] > cand[ib]):
                out[o] = buf[ia]
                ia += 1
            else:
                out[o] = cand[ib]
                ib += 1
    return out


def histogram_cut(entries, floor_key, k, bins=2048):
    """packed_merge's cut: the key of the k-th best entry at or above the
    floor, from a histogram of kBins bins (the last open above) read by 32
    lanes from the top."""
    hist = np.zeros(bins, np.int64)
    keys = entries >> 32
    for key, e in zip(keys, entries):
        if e != INT64_MIN and key >= floor_key:
            hist[min(key - floor_key, bins - 1)] += 1
    per = bins // 32
    own = hist.reshape(32, per).sum(axis=1)
    above = np.cumsum(own[::-1])[::-1]
    if above[0] < k:
        return floor_key
    lane = int(np.nonzero((above >= k) & (above - own < k))[0][0])
    b, run = lane * per + per - 1, above[lane] - own[lane]
    while b > lane * per and run + hist[b] < k:
        run += hist[b]
        b -= 1
    return floor_key + b


class TestMergeSteps:
    @pytest.mark.parametrize("k,m", [(1, 1), (10, 3), (40, 128), (256, 255), (256, 1), (33, 200)])
    def test_sort_and_merge_path(self, rng, k, m):
        pool = rng.permutation(np.unique(rng.integers(-(2**40), 2**40, 2 * (m + k))))[:m + k]
        buf = np.sort(pool[:k])[::-1].copy()
        buf[k - k // 3:] = INT64_MIN  # a buffer not yet full
        cand = pool[k:]
        merged = warp_merge_desc(buf, warp_sort_desc(cand)[:m])
        want = np.sort(np.concatenate([buf, cand]))[::-1][:k]
        np.testing.assert_array_equal(merged, want)

    @pytest.mark.parametrize("k", [1, 10, 256])
    @pytest.mark.parametrize("spread", [5, 3000])
    def test_histogram_cut_is_the_kth_key(self, rng, k, spread):
        n = 4000
        keys = rng.integers(-spread, 1, n)
        rows = rng.permutation(n)
        comp = composite_keys(torch.as_tensor(keys, dtype=torch.int32),
                              torch.as_tensor(rows)).numpy()
        kth = np.sort(keys)[::-1][k - 1]
        floor_key = int(np.sort(keys)[::-1][min(n - 1, 3 * k)])  # a lower bound
        cut = histogram_cut(comp, floor_key, k)
        if kth - floor_key < 2047:
            assert cut == kth
        else:  # the open bin holds the k-th: its lower edge bounds it
            assert cut == floor_key + 2047 and cut <= kth


def emulate_scan(keys, k, n_slabs, excl=None, round_pairs=128):
    """The selection of packed_scan + packed_merge over (N, Q) int32 keys:
    slabs of whole 128-row tiles, the CTAs advanced tile by tile in turn;
    each keeps per query a top-k buffer, admits a pair whose key reaches
    max(own k-th + 1, best published k-th) and stays at or below the bound's
    key (then strictly before the bound), pools the admitted pairs and
    merges them once round_pairs are pending, a pool holds 128, or at its
    slab's end,
    publishing its k-th keys; the merge keeps the entries at or above the
    floor's histogram cut. Returns (Q, k) composites, best first."""
    n, n_q = keys.shape
    tiles = -(-n // TILE_ROWS)
    per = -(-tiles // n_slabs) * TILE_ROWS
    comp = composite_keys(torch.as_tensor(keys), torch.arange(n)[:, None]).numpy()
    bound = np.full(n_q, np.iinfo(np.int64).max) if excl is None else excl
    hi = np.full(n_q, 1 << 30) if excl is None else (excl >> 32)
    published = np.full(n_q, np.iinfo(np.int32).min, np.int64)
    ctas = []
    for s in range(-(-n // per)):
        ctas.append(dict(t0=s * per, end=min(n, (s + 1) * per), pending=0,
                         best=np.full((n_q, k), INT64_MIN, np.int64),
                         lo=np.full(n_q, np.iinfo(np.int32).min, np.int64),
                         pools=[[] for _ in range(n_q)]))
    live = list(ctas)
    while live:
        for cta in list(live):
            t0, end = cta["t0"], min(cta["end"], cta["t0"] + TILE_ROWS)
            block = keys[t0:end].astype(np.int64)
            admitted = (block >= cta["lo"]) & (block <= hi) & (comp[t0:end] < bound)
            for r, q in zip(*np.nonzero(admitted)):
                cta["pools"][q].append(comp[t0 + r, q])
            cta["pending"] += int(admitted.sum())
            cta["t0"] = end
            last = end >= cta["end"]
            full = max(len(pool) for pool in cta["pools"]) >= TILE_ROWS
            if cta["pending"] >= round_pairs or full or last:
                cta["pending"] = 0
                for q in range(n_q):
                    pool = cta["pools"][q]
                    if pool:
                        cand = warp_sort_desc(np.array(pool, np.int64))[:len(pool)]
                        cta["best"][q] = warp_merge_desc(cta["best"][q], cand)
                        cta["pools"][q] = []
                    own = cta["best"][q, k - 1] >> 32
                    seen = published[q]
                    published[q] = max(published[q], own)
                    cta["lo"][q] = max(own + 1, seen)
            if last:
                live.remove(cta)
    out = np.empty((n_q, k), np.int64)
    for q in range(n_q):
        entries = np.concatenate([cta["best"][q] for cta in ctas])
        cut = histogram_cut(entries, published[q], k)
        kept = entries[(entries != INT64_MIN) & ((entries >> 32) >= cut)]
        out[q] = warp_merge_desc(np.full(k, INT64_MIN, np.int64),
                                 np.sort(kept)[::-1][:k]) if len(kept) else INT64_MIN
    return out


def binary_keys(rng, n, w, n_q, dup):
    """(N, Q) int32 keys -count of random rows, ``dup`` of them copies of
    row 3, against queries of which query 0 is row 3 (its copies tie)."""
    rows = words(rng, (n, w))
    rows[rng.choice(n, dup, replace=False)] = rows[3]
    qs = words(rng, (n_q, w))
    qs[0] = rows[3]
    planes, queries = (T(np.ascontiguousarray(rows.T)),), (T(qs),)
    keys = -word_scores((queries[0][:, :, None],), (planes[0][None],)).sum(dim=1, dtype=torch.int32)
    return keys.T.contiguous().numpy(), queries, planes


class TestStreamingSelection:
    @pytest.mark.parametrize("k", [1, 10, 40])
    @pytest.mark.parametrize("n_slabs", [1, 3, 7])
    @pytest.mark.parametrize("dup", [0, 300])
    @pytest.mark.parametrize("round_pairs", [128, 640])
    def test_equals_plain(self, rng, k, n_slabs, dup, round_pairs):
        keys, queries, planes = binary_keys(rng, 1500, 2, 3, dup)
        got = emulate_scan(keys, k, n_slabs, round_pairs=round_pairs)
        want = composite_keys(*tpk.packed_knn_plain(queries, planes, k)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("k", [5, 40])
    def test_resume_after_an_exclusion_bound(self, rng, k):
        keys, queries, planes = binary_keys(rng, 1500, 1, 2, 200)  # W = 1: many ties
        first = composite_keys(*tpk.packed_knn_plain(queries, planes, k)).numpy()
        got = emulate_scan(keys, k, 5, excl=first[:, -1].copy())
        want = composite_keys(*tpk.packed_knn_plain(
            queries, planes, k, excl=split_composite(torch.as_tensor(first[:, -1])))).numpy()
        np.testing.assert_array_equal(got, want)


def _smem(planes, nq, w, k, resident):
    """csrc/packed_knn.cu:make_layout, each term rounded up to 16 bytes."""
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    steps = -(-w // 8)
    terms = [8 * nq * k, 8 * nq * 256, 8 * 4 * k, 8 * nq,
             32 * planes * (steps if resident else 3) * nq, 8 * nq, 4 * nq, 4 * nq]
    return sum(up(x) for x in terms) + 16


class TestTiling:
    @pytest.mark.parametrize("n_q,tile", [(1, 8), (5, 8), (16, 16), (32, 32), (33, 64), (64, 64)])
    @pytest.mark.parametrize("k", [1, 10, 40, 256])
    @pytest.mark.parametrize("w", [1, 3, 24, 64])
    @pytest.mark.parametrize("planes", [1, 2])
    def test_pinned(self, n_q, tile, k, w, planes):
        want = min(tile, 16) if k == 256 else tile  # tile x k <= 4096
        got = tpk.tiling(n_q, w, k, planes)
        assert got == tpk.Tiling(want, -(-w // 8), _smem(planes, want, w, k, True), True)
        assert got.smem <= 232_448

    @pytest.mark.parametrize("planes,w", [(1, 8000), (2, 4000)])
    def test_wide_queries_stage_per_item(self, planes, w):
        got = tpk.tiling(5, w, 10, planes)
        assert got == tpk.Tiling(8, w // 8, _smem(planes, 8, w, 10, False), False)

    def test_raises_naming_the_limit(self):
        with pytest.raises(ContractError, match="packed_scan: k=4000 .* at most 232448"):
            tpk.tiling(5, 24, 4000, 1)
        with pytest.raises(ContractError, match="fewer than 16777216"):
            tpk.tiling(5, 1 << 24, 10, 2)


class TestPlainAgainstJaxOverlapping:
    @pytest.mark.parametrize("w,n_q", [(1, 1), (3, 5), (9, 16)])
    def test_ternary_overlapping_planes(self, rng, w, n_q):
        """Raw planes may share a position: the plain version scores them
        as the JAX kernel does (interpret mode)."""
        n = 2100
        pos, neg = words(rng, (n, w)), words(rng, (n, w))
        pos[[50, 900]] = pos[7]
        neg[[50, 900]] = neg[7]
        qp, qn = words(rng, (n_q, w)), words(rng, (n_q, w))
        qp[0], qn[0] = pos[7], neg[7]
        assert ((pos & neg) != 0).any()
        pt, nt = np.ascontiguousarray(pos.T), np.ascontiguousarray(neg.T)
        jd, ji = jpk.fused_ternary_knn_batch(
            jnp.asarray(qp), jnp.asarray(qn), jnp.asarray(pt), jnp.asarray(nt), 7)
        td, ti = tpk.packed_knn_plain((T(qp), T(qn)), (T(pt), T(nt)), 7)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
