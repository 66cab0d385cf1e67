"""innr_tpu_torch.kernels.knn against innr_tpu.kernels.knn.

The same numpy inputs go through the JAX Pallas kernel (interpret mode on
the CPU, as innr_tpu's own tests run it) and the port, which runs the plain
PyTorch version of its CUDA kernel on CPU tensors.

Tolerances:
- integer-valued inputs (dot / l2 / masked modes, f32 and bf16 corpora, u8):
  exact keys and indices, ties included — every score is exact;
- cosine (unit queries are not integer-valued): scores within 1e-5,
  indices equal wherever the neighbouring-rank gap exceeds it;
- Gaussian inputs: scores within cond_tol (32 eps sum|q_i r_i|, and the L2
  decomposition's terms), indices equal where the gap exceeds it;
- u8 on Gaussian queries: 1e-5 sum|q_i c_i| + cond_tol, covering the TPU's
  hi/lo bf16 query split (~2^-18 relative per product).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from innr_tpu.kernels import knn as jk  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


N = 2100  # >= innr_tpu.config.MIN_ROWS_PALLAS, not a multiple of any tile
EPS = float(np.finfo(np.float32).eps)
MODES = ("dot", "l2", "cosine", "dotm", "l2m", "cosinem")


def assert_topk_agrees(vals, idx, want_vals, want_idx, tol):
    """Scores within ``tol`` ((Q, 1) or scalar; NaN matches NaN); indices
    equal wherever ``want_vals`` separates a rank from its neighbours in the
    returned list by more than 2 tol."""
    v = np.asarray(vals, np.float64)
    w = np.asarray(want_vals, np.float64)
    v, w = np.atleast_2d(v), np.atleast_2d(w)
    i, wi = np.atleast_2d(np.asarray(idx)), np.atleast_2d(np.asarray(want_idx))
    tol = np.broadcast_to(np.asarray(tol, np.float64).reshape(-1, 1), (w.shape[0], 1))
    same = (np.isnan(v) & np.isnan(w)) | (np.abs(v - w) <= tol) | (v == w)
    assert same.all(), f"scores differ: {v[~same]} vs {w[~same]}"
    gaps = np.abs(np.diff(w, axis=1))
    inf = np.full((w.shape[0], 1), np.inf)
    sep = (np.concatenate([inf, gaps], 1) > 2 * tol) & (np.concatenate([gaps, inf], 1) > 2 * tol)
    np.testing.assert_array_equal(i[sep], wi[sep])


def int_data(rng, n_q, d, dtype="float32", n=N):
    """Integer-valued corpus in {-4..4} (u8: codes 0..255) with a planted
    NaN row and a -0.0 row, queries in {-4..4}, and a ~60% predicate."""
    if dtype == "uint8":
        rows = rng.integers(0, 256, (n, d)).astype(np.uint8)
    else:
        rows = rng.integers(-4, 5, (n, d)).astype(np.float32)
        rows[11] = np.nan
        rows[29] = -0.0
    qs = rng.integers(-4, 5, (n_q, d)).astype(np.float32)
    mask = rng.random(n) < 0.6
    return rows, qs, mask


def jax_rows(rows, dtype):
    if dtype == "bfloat16":
        return jnp.asarray(rows.astype(ml_dtypes.bfloat16))
    return jnp.asarray(rows)


def torch_rows(rows, dtype):
    t = torch.from_numpy(np.ascontiguousarray(rows))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def jax_aux(mode, jrows, mask):
    r = jrows.astype(jnp.float32)
    norms2 = jnp.sum(r * r, axis=1)
    inv = jk.inv_norms(jrows)
    m = jnp.asarray(mask, jnp.float32)
    return {"dot": None, "l2": norms2, "cosine": inv, "dotm": m,
            "l2m": jnp.stack([norms2, m]), "cosinem": jnp.stack([inv, m])}[mode]


def torch_aux(mode, trows, mask):
    norms2 = tk._norms2(trows)
    inv = tk.inv_norms(trows)
    m = torch.from_numpy(mask.astype(np.float32))
    return {"dot": None, "l2": norms2, "cosine": inv, "dotm": m,
            "l2m": torch.stack([norms2, m]), "cosinem": torch.stack([inv, m])}[mode]


def both_keys(rows, qs, mask, k, mode, dtype):
    jr, tr = jax_rows(rows, dtype), torch_rows(rows, dtype)
    jq, tq = jnp.asarray(qs), torch.from_numpy(qs)
    if mode.startswith("cos"):
        jq, tq = jk._unit_queries(jq), tk._unit_queries(tq)
    jkeys, jidx = jk.fused_knn_keys_batch(jq, jr, jax_aux(mode, jr, mask), k, mode)
    tkeys, tidx = tk.fused_knn_keys_batch(tq, tr, torch_aux(mode, tr, mask), k, mode)
    return (np.asarray(jkeys), np.asarray(jidx)), (tkeys.numpy(), tidx.numpy())


def key_scores(keys, mode):
    keys = np.array(keys)
    if mode in ("l2", "l2m"):
        keys = ~keys
    return tk.invert_total_key(torch.from_numpy(keys)).numpy()


class TestKeysAgainstJax:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("mode", MODES)
    def test_every_mode(self, rng, mode, dtype):
        rows, qs, mask = int_data(rng, 3, 17, dtype)
        (jkeys, jidx), (tkeys, tidx) = both_keys(rows, qs, mask, 7, mode, dtype)
        if mode.startswith("cos"):
            assert_topk_agrees(key_scores(tkeys, mode), tidx,
                               key_scores(jkeys, mode), jidx, 1e-5)
        else:
            np.testing.assert_array_equal(tkeys, jkeys)
            np.testing.assert_array_equal(tidx, jidx)

    @pytest.mark.parametrize("n_q,d,k", [(1, 1, 1), (3, 17, 7), (8, 128, 7), (8, 128, 1)])
    @pytest.mark.parametrize("mode", ["dot", "l2"])
    def test_shapes(self, rng, n_q, d, k, mode):
        rows, qs, mask = int_data(rng, n_q, d)
        (jkeys, jidx), (tkeys, tidx) = both_keys(rows, qs, mask, k, mode, "float32")
        np.testing.assert_array_equal(tkeys, jkeys)
        np.testing.assert_array_equal(tidx, jidx)

    def test_u8(self, rng):
        codes, qs, _ = int_data(rng, 3, 17, "uint8")
        jv, ji = jk.fused_knn_u8_batch(jnp.asarray(qs), jnp.asarray(codes), 7)
        tv, ti = tk.fused_knn_u8_batch(torch.from_numpy(qs), torch.from_numpy(codes), 7)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    @pytest.mark.parametrize("mode", ["dot", "l2m"])
    def test_multi_pass_with_cap_patched_down(self, rng, monkeypatch, mode):
        """k beyond the pass cap: exclusion-bounded passes whose
        concatenation equals JAX's single ideal selection, ties included."""
        monkeypatch.setattr(tk, "_K_MAX_PASS", 16)
        assert tk.single_pass_k(3) == 16
        rows, qs, mask = int_data(rng, 3, 8)
        (jkeys, jidx), (tkeys, tidx) = both_keys(rows, qs, mask, 45, mode, "float32")
        np.testing.assert_array_equal(tkeys, jkeys)
        np.testing.assert_array_equal(tidx, jidx)

    def test_exclusion_bound(self, rng):
        """knn_plain's excl resumes strictly after (key, idx), as the JAX
        kernel's excl does."""
        rows, qs, _ = int_data(rng, 3, 8)
        jr, tr = jnp.asarray(rows), torch.from_numpy(rows)
        first_k, first_i = tk.knn_plain(torch.from_numpy(qs), tr, None, 5, "dot")
        excl = (first_k[:, -1], first_i[:, -1])
        tkeys, tidx = tk.knn_plain(torch.from_numpy(qs), tr, None, 7, "dot", excl=excl)
        jkeys, jidx = jk._fused_knn_raw(
            jnp.asarray(qs), jr, None, 7, "dot",
            (jnp.asarray(excl[0].numpy()), jnp.asarray(excl[1].numpy())),
        )
        np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        full_k, full_i = tk.knn_plain(torch.from_numpy(qs), tr, None, 12, "dot")
        np.testing.assert_array_equal(full_i[:, 5:].numpy(), tidx.numpy())

    def test_multi_pass_driver_equals_one_selection(self, rng):
        rows, qs, mask = int_data(rng, 4, 5)
        tr, tq = torch.from_numpy(rows), torch.from_numpy(qs)
        vals, m = tk._split_aux(torch_aux("l2m", tr, mask), "l2m", N)
        one = tk._plain_top(tq, tr, vals, m, 100, "l2m")
        many = tk._multi_pass(
            lambda pk, bound: tk._plain_top(tq, tr, vals, m, pk, "l2m", bound), 100, 7
        )
        assert torch.equal(one, many)


class TestWrappersGaussian:
    D, Q, K = 32, 3, 7

    @pytest.fixture
    def data(self, rng):
        rows = rng.standard_normal((N, self.D)).astype(np.float32)
        qs = rng.standard_normal((self.Q, self.D)).astype(np.float32)
        dot_tol = 32 * EPS * (np.abs(qs) @ np.abs(rows).T).max(axis=1, keepdims=True)
        l2_tol = (32 * EPS * ((rows * rows).sum(1).max() + (qs * qs).sum(1, keepdims=True))
                  + 2 * dot_tol)
        return rows, qs, dot_tol, l2_tol

    def test_dot_batch(self, data):
        rows, qs, dot_tol, _ = data
        jv, ji = jk.fused_knn_dot_batch(jnp.asarray(qs), jnp.asarray(rows), self.K)
        tv, ti = tk.fused_knn_dot_batch(torch.from_numpy(qs), torch.from_numpy(rows), self.K)
        assert_topk_agrees(tv, ti, jv, ji, dot_tol)

    def test_dot_single(self, data):
        rows, qs, dot_tol, _ = data
        jv, ji = jk.fused_knn_dot(jnp.asarray(qs[1]), jnp.asarray(rows), self.K)
        tv, ti = tk.fused_knn_dot(torch.from_numpy(qs[1]), torch.from_numpy(rows), self.K)
        assert tv.shape == (self.K,) and ti.dtype == torch.int32
        assert_topk_agrees(tv, ti, jv, ji, dot_tol[1])

    def test_l2_batch_and_single(self, data):
        rows, qs, _, l2_tol = data
        jv, ji = jk.fused_knn_l2_batch(jnp.asarray(qs), jnp.asarray(rows), self.K)
        tv, ti = tk.fused_knn_l2_batch(torch.from_numpy(qs), torch.from_numpy(rows), self.K)
        assert_topk_agrees(tv, ti, jv, ji, l2_tol)
        sv, si = tk.fused_knn_l2(torch.from_numpy(qs[0]), torch.from_numpy(rows), self.K)
        assert_topk_agrees(sv, si, jv[0], ji[0], l2_tol[0])
        assert (tv >= 0).all()

    def test_l2_masked(self, data, rng):
        rows, qs, _, l2_tol = data
        mask = rng.random(N) < 0.4
        jv, ji = jk.fused_knn_l2_masked_batch(
            jnp.asarray(qs), jnp.asarray(rows), jnp.asarray(mask), self.K)
        tv, ti = tk.fused_knn_l2_masked_batch(
            torch.from_numpy(qs), torch.from_numpy(rows), torch.from_numpy(mask), self.K)
        assert_topk_agrees(tv, ti, jv, ji, l2_tol)
        assert mask[ti.numpy()].all()

    def test_cosine_batch_and_single(self, data):
        rows, qs, _, _ = data
        rows[5] = 0.0  # zero-norm row scores exactly 0.0
        jv, ji = jk.fused_knn_cosine_batch(jnp.asarray(qs), jnp.asarray(rows), self.K)
        tv, ti = tk.fused_knn_cosine_batch(torch.from_numpy(qs), torch.from_numpy(rows), self.K)
        assert_topk_agrees(tv, ti, jv, ji, 1e-5)
        sv, si = tk.fused_knn_cosine(torch.from_numpy(qs[2]), torch.from_numpy(rows), self.K)
        assert_topk_agrees(sv, si, jv[2], ji[2], 1e-5)

    def test_u8_gaussian_queries(self, rng):
        codes = rng.integers(0, 256, (N, 24)).astype(np.uint8)
        qs = rng.standard_normal((2, 24)).astype(np.float32)
        cond = (np.abs(qs) @ codes.T.astype(np.float64)).max(axis=1, keepdims=True)
        tol = 1e-5 * cond + 32 * EPS * cond
        jv, ji = jk.fused_knn_u8_batch(jnp.asarray(qs), jnp.asarray(codes), self.K)
        tv, ti = tk.fused_knn_u8_batch(torch.from_numpy(qs), torch.from_numpy(codes), self.K)
        assert_topk_agrees(tv, ti, jv, ji, tol)

    def test_inv_norms_and_unit_queries(self, data):
        rows, qs, _, _ = data
        rows[0] = 0.0
        qs[1] = 0.0
        np.testing.assert_allclose(
            tk.inv_norms(torch.from_numpy(rows)).numpy(),
            np.asarray(jk.inv_norms(jnp.asarray(rows))), rtol=1e-6)
        unit = tk._unit_queries(torch.from_numpy(qs)).numpy()
        np.testing.assert_allclose(
            unit, np.asarray(jk._unit_queries(jnp.asarray(qs))), rtol=1e-6, atol=1e-7)
        assert (unit[1] == 0.0).all()


class TestPlainSemantics:
    def test_nan_inf_and_zero_order(self):
        """Canonical NaN sorts greatest for dot, last for L2; +inf next;
        equal scores go to the lowest row."""
        rows = torch.tensor([[1.0], [np.nan], [np.inf], [1.0], [-np.inf], [-0.0]])
        q = torch.tensor([[1.0]])
        keys, idx = tk.knn_plain(q, rows, None, 6, "dot")
        assert idx.tolist() == [[1, 2, 0, 3, 5, 4]]
        # L2: the NaN row and the +inf row (inf - 2 inf = NaN) sort last,
        # in row order.
        keys, idx = tk.knn_plain(q, rows, tk._norms2(rows), 6, "l2")
        assert idx[0, -2:].tolist() == [1, 2]

    def test_negative_nan_payload_is_canonical(self):
        neg_nan = torch.tensor([-1], dtype=torch.int32).view(torch.float32)  # 0xFFFFFFFF
        rows = torch.stack([torch.ones(1), neg_nan, 2 * torch.ones(1)])
        keys, idx = tk.knn_plain(torch.ones(1, 1), rows, None, 3, "dot")
        assert idx.tolist() == [[1, 2, 0]]
        assert keys[0, 0] == 0x7FC00000

    def test_tail_slots_after_exclusion_are_empty(self):
        rows = torch.arange(4.0)[:, None]
        q = torch.ones(1, 1)
        keys, idx = tk.knn_plain(q, rows, None, 3, "dot")
        k2, i2 = tk.knn_plain(q, rows, None, 3, "dot", excl=(keys[:, -1], idx[:, -1]))
        assert i2.tolist() == [[0, -1, -1]]
        assert k2[0, 1] == torch.iinfo(torch.int32).min

    def test_force_reference_runs_plain(self, monkeypatch):
        from innr_tpu_torch import config

        rows = torch.randn(50, 4, generator=torch.Generator().manual_seed(0))
        want = tk.knn_plain(rows[:2], rows, None, 5, "dot")
        monkeypatch.setattr(config, "_FORCE_REFERENCE", True)
        got = tk.fused_knn_keys_batch(rows[:2], rows, None, 5, "dot")
        assert all(torch.equal(a, b) for a, b in zip(got, want))


class TestContracts:
    @pytest.mark.parametrize("bad", [
        dict(mode="nope"),
        dict(mode="l2", aux=None),
        dict(mode="dot", aux=torch.ones(10)),
        dict(mode="l2m", aux=torch.ones(10)),
        dict(k=0),
        dict(k=11),
        dict(rows=torch.ones(10, 4, dtype=torch.float64)),
        dict(qs=torch.ones(2, 3)),
        dict(qs=torch.ones(2, 4, dtype=torch.float64)),
    ])
    def test_raises(self, bad):
        args = dict(qs=torch.ones(2, 4), rows=torch.ones(10, 4), aux=None, k=3, mode="dot")
        args.update(bad)
        with pytest.raises(ContractError):
            tk.fused_knn_keys_batch(args["qs"], args["rows"], args["aux"], args["k"], args["mode"])

    def test_u8_wrapper_rejects_float_codes(self):
        with pytest.raises(ContractError, match="uint8"):
            tk.fused_knn_u8_batch(torch.ones(1, 4), torch.ones(10, 4), 2)

    def test_meta_device_raises_not_falls_back(self):
        with pytest.raises(ContractError, match="unsupported device"):
            tk.fused_knn_keys_batch(torch.ones(1, 4, device="meta"),
                                    torch.ones(10, 4, device="meta"), None, 2, "dot")


class _FakeLib:
    """The library's K1 entry points as a stand-in that records each call:
    the tile grid 64 queries x 2 CTAs an SM; the wide grid 1 CTA an SM of
    two 64-query warpgroups, or none (0, 0) where the wide scan has no
    layout (not f32, D above 96 or not a multiple of 4)."""

    def __init__(self):
        self.scans, self.grids = [], []

    def innr_knn_grid(self, dtype, n_q, d, k, wide, info):
        self.grids.append((dtype, n_q, d, k, wide))
        if not wide:
            info[0], info[1] = 64, 2
        elif dtype != 0 or d > 96 or d % 4:
            info[0], info[1] = 0, 0
        else:
            info[0], info[1] = 128, 1
        return 0

    def innr_knn_scan(self, *args):
        self.scans.append(args)
        return 0

    def innr_knn_merge(self, *args):
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """_scan_pass on CPU tensors against _FakeLib on a card of 132 SMs;
    records the shared keys' sizes it asks for."""
    import contextlib
    from types import SimpleNamespace

    from innr_tpu_torch.kernels import _build

    lib, keys = _FakeLib(), []
    real_keys = tk.shared_keys

    def shared_keys(n_q, n_slabs, dev):
        keys.append((n_q, n_slabs))
        return real_keys(n_q, n_slabs, dev)

    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(tk, "_GRIDS", {})
    monkeypatch.setattr(tk, "shared_keys", shared_keys)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    return lib, keys


class TestWidePlanner:
    """The planner's side of the two K1 schedules, on the CPU."""

    @pytest.mark.parametrize("n_q,d,dtype,path", [
        (tk._WIDE_MIN_QUERIES, 96, torch.float32, "wide"),
        (10_000, 96, torch.float32, "wide"),
        (10_000, 128, torch.float32, "tile"),  # no 64-query layout
        (10_000, 4, torch.float32, "wide"),
        (tk._WIDE_MIN_QUERIES - 1, 96, torch.float32, "tile"),
        (32, 96, torch.float32, "tile"),
        (10_000, 132, torch.float32, "tile"),  # the layout does not fit
        (10_000, 98, torch.float32, "tile"),  # rows not in 16-byte vectors
        (10_000, 96, torch.bfloat16, "tile"),
        (10_000, 96, torch.uint8, "tile"),
    ])
    def test_path_by_queries_dim_and_dtype(self, fake_card, n_q, d, dtype, path):
        """The path the planner takes where the library plans as the stand-in
        does; below every crossover it does not ask the library."""
        lib, _ = fake_card
        assert tk.scan_path(torch.empty(0, d, dtype=dtype), n_q, 10) == path
        assert bool(lib.grids) == (n_q >= tk._WIDE_MIN_QUERIES)

    @pytest.mark.parametrize("has_layout", [False, True])
    def test_path_follows_the_library_from_the_crossover(self, fake_card, monkeypatch,
                                                         has_layout):
        """Wide exactly where the library has a layout and Q reaches the
        crossover; the library is asked once per shape."""
        lib, _ = fake_card
        asked = []

        def grid(dtype, n_q, d, k, wide, info):
            asked.append((n_q, k, wide))
            info[0], info[1] = (128 * has_layout, 1) if wide else (64, 2)
            return 0

        monkeypatch.setattr(lib, "innr_knn_grid", grid)
        rows = torch.empty(0, 96)
        for n_q in (1, 64, 255, 256, 1000, 10_000, 100_000):
            for _ in range(2):
                want = "wide" if has_layout and n_q >= tk._WIDE_MIN_QUERIES else "tile"
                assert tk.scan_path(rows, n_q, 10) == want, n_q
        assert asked == [(n_q, 10, 1) for n_q in (256, 1000, 10_000, 100_000)]

    @pytest.mark.parametrize("n", [10_000_000, 100_000_000])
    @pytest.mark.parametrize("q_tiles", [1, 2, 3, 7, 8, 79, 200])
    @pytest.mark.parametrize("n_ctas", [132, 264])
    def test_wide_slabs_deal_every_cta_the_same_items(self, n, q_tiles, n_ctas):
        """Each CTA walks `per_cta` items (at least 8), or one fewer where
        the slabs' rounding to whole row tiles left the last slabs out."""
        slab_rows = tk._wide_slab_rows(n, q_tiles, n_ctas)
        items = q_tiles * -(-n // slab_rows)
        per_cta = q_tiles * -(-tk._WIDE_ITEMS_PER_CTA // q_tiles)
        assert slab_rows % tk._ROW_TILE == 0 and per_cta >= tk._WIDE_ITEMS_PER_CTA
        assert -(-items // n_ctas) == per_cta
        assert n_ctas * per_cta - items < 0.01 * n_ctas * per_cta  # idle in the last round

    def test_short_corpus_takes_fewer_slabs(self):
        slab_rows = tk._wide_slab_rows(3_000, 8, 132)
        assert slab_rows == tk._ROW_TILE and -(-3_000 // slab_rows) == 24

    @pytest.mark.parametrize("n_q,n", [(1_000, 100_000), (10_000, 3_000), (257, 5_000_000)])
    def test_wide_launch_grid_slabs_keys_and_counter(self, fake_card, n_q, n):
        lib, keys = fake_card
        rows, qs = torch.zeros(n, 96), torch.ones(n_q, 96)
        before = dict(tk.LAUNCHES_BY_PATH)
        out = tk._scan_pass(qs, rows, None, None, 10, "dot", None)
        assert out.shape == (n_q, 10)
        (scan,) = lib.scans
        slab_rows, n_ctas = scan[-3], scan[-2]
        assert n_ctas == 132  # one resident CTA x 132 SMs, persistent
        assert slab_rows == tk._wide_slab_rows(n, -(-n_q // 128), 132)
        assert keys == [(n_q, -(-n // slab_rows))]  # one published key a slab
        assert tk.LAUNCHES_BY_PATH == {**before, "wide": before["wide"] + 1}
        assert tk._THIS_THREAD.path == "wide"

    def test_tile_launch_keeps_the_slab_grid(self, fake_card):
        lib, keys = fake_card
        n_q, n = 32, 100_000
        before = dict(tk.LAUNCHES_BY_PATH)
        tk._scan_pass(torch.ones(n_q, 96), torch.zeros(n, 96), None, None, 10, "dot", None)
        (scan,) = lib.scans
        slab_rows, n_ctas = scan[-3], scan[-2]
        assert n_ctas == 0
        assert slab_rows == tk._slab_rows(n, 1, 10, None, tk._ROW_TILE, 2, 1)
        assert keys == [(n_q, -(-n // slab_rows))]
        assert tk.LAUNCHES_BY_PATH == {**before, "tile": before["tile"] + 1}
        assert tk._THIS_THREAD.path == "tile"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


def _int_corpus(dev, n, d, n_q, seed):
    """Integer rows and queries in [-4, 4] (every score exact, many ties)
    and a predicate passing about 70% of the rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(-4, 5, (n, d), generator=gen, device=dev).float()
    qs = torch.randint(-4, 5, (n_q, d), generator=gen, device=dev).float()
    mask = (torch.rand(n, generator=gen, device=dev) < 0.7).float()
    return rows, qs, mask


def _mode_aux(mode, rows, mask):
    norms2, inv = tk._norms2(rows), tk.inv_norms(rows)
    return {"dot": None, "l2": norms2, "cosine": inv, "dotm": mask,
            "l2m": torch.stack([norms2, mask]), "cosinem": torch.stack([inv, mask])}[mode]


def _on_path(monkeypatch, path, *args, **kwargs):
    """fused_knn_keys_batch with the planner's schedule forced to ``path``."""
    monkeypatch.setattr(tk, "scan_path", lambda *args: path)
    before = tk.LAUNCHES_BY_PATH[path]
    out = tk.fused_knn_keys_batch(*args, **kwargs)
    assert tk.LAUNCHES_BY_PATH[path] > before
    return out


def _same(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
class TestKernelOnCuda:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
    @pytest.mark.parametrize("k", [1, 10, 259])
    def test_kernel_matches_plain_exactly(self, cuda_device, dtype, k):
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        if dtype == torch.uint8:
            rows = torch.randint(0, 256, (3077, 127), generator=gen, device=cuda_device,
                                 dtype=torch.uint8)
        else:
            rows = torch.randint(-4, 5, (3077, 127), generator=gen,
                                 device=cuda_device).to(dtype)
        qs = torch.randint(-4, 5, (5, 127), generator=gen, device=cuda_device).float()
        before = tk.LAUNCHES
        got = tk.fused_knn_keys_batch(qs, rows, None, k, "dot")
        assert tk.LAUNCHES > before
        want = tk.knn_plain(qs, rows, None, k, "dot")
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    @pytest.mark.parametrize("n_q,n,d", [
        (65, 3077, 96),      # one query tile pair, half of it empty
        (200, 333, 64),      # N below one item a CTA: 3 slabs
        (1000, 70_001, 32),  # N not a multiple of the slab
        (200, 50_000, 96),
    ])
    @pytest.mark.parametrize("mode", MODES)
    def test_wide_matches_plain_and_tile_exactly(self, cuda_device, monkeypatch, n_q, n, d, mode):
        rows, qs, mask = _int_corpus(cuda_device, n, d, n_q, 11)
        aux = _mode_aux(mode, rows, mask)
        ks = [k for k in (1, 10, 12, 32, 40) if tk._grid(rows, n_q, k, "wide")[0]]
        assert ks[:3] == [1, 10, 12]  # each k whose wide layout fits at this D
        for k in ks:
            want = tk.knn_plain(qs, rows, aux, k, mode)
            assert _same(_on_path(monkeypatch, "wide", qs, rows, aux, k, mode), want), k
            assert _same(_on_path(monkeypatch, "tile", qs, rows, aux, k, mode), want), k

    @pytest.mark.parametrize("n_q,n,d", [(300, 20_011, 96), (257, 9001, 64), (1000, 50_000, 32)])
    @pytest.mark.parametrize("mode", ["dot", "l2", "cosinem"])
    def test_wide_on_float_rows(self, cuda_device, monkeypatch, n_q, n, d, mode):
        """Random unit rows and queries: the 3xTF32 low parts are nonzero,
        so the margin and the exact re-score decide near scores. The wide
        schedule equals the tile schedule bit for bit, and the plain version
        within rounding (indices wherever its scores are separated)."""
        from innr_tpu_torch.utils.order import invert_total_key

        gen = torch.Generator(device=cuda_device).manual_seed(16)
        rows = torch.randn(n, d, generator=gen, device=cuda_device)
        rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
        qs = torch.randn(n_q, d, generator=gen, device=cuda_device)
        qs /= torch.linalg.vector_norm(qs, dim=1, keepdim=True)
        mask = (torch.rand(n, generator=gen, device=cuda_device) < 0.7).float()
        aux = _mode_aux(mode, rows, mask)
        k, tol = 10, 1e-5

        def scores(keys):
            return invert_total_key(~keys if mode.startswith("l2") else keys).double()

        got = _on_path(monkeypatch, "wide", qs, rows, aux, k, mode)
        assert _same(got, _on_path(monkeypatch, "tile", qs, rows, aux, k, mode))
        pk, pi = tk.knn_plain(qs, rows, aux, k + 1, mode)
        want = scores(pk)
        assert bool(((scores(got[0]) - want[:, :k]).abs() <= tol).all())
        gaps = (want[:, 1:] - want[:, :-1]).abs()
        inf = torch.full_like(want[:, :1], float("inf"))
        separated = (torch.cat([inf, gaps[:, :k - 1]], dim=1) > 2 * tol) & (gaps[:, :k] > 2 * tol)
        assert bool((got[1] == pi[:, :k])[separated].all())

    @pytest.mark.parametrize("mode", ["dot", "l2m"])
    def test_wide_row_ids_exclusion_and_multi_pass(self, cuda_device, monkeypatch, mode):
        n, d, n_q = 20_011, 96, 300
        rows, qs, mask = _int_corpus(cuda_device, n, d, n_q, 12)
        aux = _mode_aux(mode, rows, mask)
        gen = torch.Generator(device=cuda_device).manual_seed(13)
        ids = torch.randperm(n, generator=gen, device=cuda_device).to(torch.int32)
        monkeypatch.setattr(tk, "single_pass_k", lambda n_q: 8)
        k = 20  # passes of 8, 8 and 4, each resuming after the last
        want = tk.knn_plain(qs, rows, aux, k, mode, row_ids=ids)
        assert _same(_on_path(monkeypatch, "wide", qs, rows, aux, k, mode, row_ids=ids), want)
        vals, pred = tk._split_aux(aux, mode, n)
        bound = tk._plain_top(qs, rows, vals, pred, 7, mode, row_ids=ids)[:, -1].contiguous()
        before = tk.LAUNCHES_BY_PATH["wide"]
        got = tk._scan_pass(qs, rows, vals, pred, 10, mode, bound, ids)
        assert tk.LAUNCHES_BY_PATH["wide"] == before + 1
        assert torch.equal(got, tk._plain_top(qs, rows, vals, pred, 10, mode, bound, ids))

    @pytest.mark.parametrize("d,dtype,k", [
        (132, torch.float32, 10), (98, torch.float32, 10), (96, torch.bfloat16, 10),
        (128, torch.float32, 10), (100, torch.float32, 10),  # D above 96
        (96, torch.float32, 13), (96, torch.float32, 100),  # the layout does not fit
    ])
    def test_planner_falls_back_to_tile(self, cuda_device, d, dtype, k):
        n_q = tk._WIDE_MIN_QUERIES + 3
        rows, qs, _ = _int_corpus(cuda_device, 4099, d, n_q, 14)
        rows = rows.to(dtype)
        before = dict(tk.LAUNCHES_BY_PATH)
        got = tk.fused_knn_keys_batch(qs, rows, None, k, "dot")
        assert tk.LAUNCHES_BY_PATH == {**before, "tile": before["tile"] + 1}
        assert _same(got, tk.knn_plain(qs, rows, None, k, "dot"))

    @pytest.mark.parametrize("n_q,path", [(tk._WIDE_MIN_QUERIES - 1, "tile"),
                                          (tk._WIDE_MIN_QUERIES, "wide")])
    def test_planner_takes_wide_from_the_crossover(self, cuda_device, n_q, path):
        rows, qs, mask = _int_corpus(cuda_device, 9001, 96, n_q, 15)
        aux = _mode_aux("l2", rows, mask)
        before = dict(tk.LAUNCHES_BY_PATH)
        got = tk.fused_knn_keys_batch(qs, rows, aux, 10, "l2")
        assert tk.LAUNCHES_BY_PATH == {**before, path: before[path] + 1}
        assert _same(got, tk.knn_plain(qs, rows, aux, 10, "l2"))
