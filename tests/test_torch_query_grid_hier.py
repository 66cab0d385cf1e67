"""QueryParallelIndex, GridIndex and HierarchicalCorpus of
innr_tpu_torch.parallel against innr_tpu.parallel.

The JAX side runs on its 8 virtual CPU devices, the port on meshes of
``"cpu"`` entries of the same shapes; both get the same numpy draws.
Integer-valued rows: indices and scores bit for bit (many exact ties, which
go to the lowest global index); Gaussian rows: indices equal, scores within
``cond_tol``. The hierarchical merge must equal the flat merge of
``ShardedCorpus`` bit for bit, NaN rows across slices included. The ``cuda``
class holds 2 x 2 meshes of ``cuda:0`` to the single-card call on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu.parallel as jp  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
import innr_tpu_torch.parallel as tp  # noqa: E402
from conftest import cond_tol  # noqa: E402
from innr_tpu_torch import config  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


CPU8 = ["cpu"] * 8
METHODS = {"dot": "knn_dot", "l2": "knn_l2", "cosine": "knn_cosine"}
FULL = {"dot": tt.batch_knn_dot, "l2": tt.batch_knn, "cosine": tt.batch_knn_cosine}


def int_rows(rng, n, d, lo=-3, hi=4):
    return rng.integers(lo, hi, (n, d)).astype(np.float32)


def np_(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def check(got, want, exact, qs=None, rows=None):
    np.testing.assert_array_equal(np_(got[1]), np_(want[1]))
    if exact:
        assert same_bits(np_(got[0]), np_(want[0]))
        return
    idx = np_(got[1])
    for qi in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            tol = 2 * cond_tol(qs[qi], rows[idx[qi, j]]) + cond_tol(qs[qi], qs[qi]) + cond_tol(
                rows[idx[qi, j]], rows[idx[qi, j]]) + 1e-6
            assert abs(float(np_(got[0])[qi, j]) - float(np_(want[0])[qi, j])) <= tol


class TestQueryParallel:
    @pytest.mark.parametrize("mode", ["dot", "l2"])
    def test_integer_rows_bit_for_bit(self, rng, mode):
        rows, qs = int_rows(rng, 300, 32), int_rows(rng, 19, 32)  # 19: ragged slices
        got = getattr(tp.QueryParallelIndex(rows, tp.default_mesh(CPU8)), METHODS[mode])(qs, 5)
        check(got, getattr(jp.QueryParallelIndex(rows), METHODS[mode])(qs, 5), True)
        full = FULL[mode](qs, tt.VerticalBatch(rows), 5)
        check(got, (full.scores, full.indices), True)

    def test_cosine_gaussian(self, rng):
        rows = rng.standard_normal((300, 32)).astype(np.float32)
        qs = rng.standard_normal((19, 32)).astype(np.float32)
        got = tp.QueryParallelIndex(rows, tp.default_mesh(CPU8)).knn_cosine(qs, 5)
        want = jp.QueryParallelIndex(rows).knn_cosine(qs, 5)
        np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
        np.testing.assert_allclose(np_(got[0]), np.asarray(want[0]), rtol=0, atol=1e-5)

    def test_replica_once_per_distinct_device_and_filtered(self, rng):
        rows, qs = int_rows(rng, 200, 16), int_rows(rng, 7, 16)
        qp = tp.QueryParallelIndex(rows, tp.default_mesh(CPU8))
        assert list(qp.replicas) == [torch.device("cpu")]
        mask = rng.random(200) < 0.4
        check(qp.knn_filtered(qs, 6, mask), jp.QueryParallelIndex(rows).knn_filtered(
            qs, 6, mask), True)
        m = np.zeros(200, bool)
        m[[1, 30]] = True
        assert np_(qp.knn_filtered(qs, 10, m)[1]).shape == (7, 2)
        assert np_(qp.knn_filtered(qs, 5, np.zeros(200, bool))[0]).shape == (7, 0)
        assert np.all(np_(qp.knn_filtered(qs, 3, lambda j: j % 2 == 0)[1]) % 2 == 0)

    def test_edges_and_bf16(self, rng):
        rows = int_rows(rng, 50, 16)
        qp = tp.QueryParallelIndex(rows, tp.default_mesh(CPU8))
        assert np_(qp.knn_dot(rows[:3], 0)[0]).shape == (3, 0)
        assert np_(qp.knn_dot(rows[:2], 500)[1]).shape == (2, 50)
        assert np_(qp.knn_dot(rows[:0], 3)[1]).shape == (0, 3)
        with pytest.raises(tt.ContractError):
            qp.knn_dot(rows[0], 3)
        with pytest.raises(tt.ContractError):
            tp.QueryParallelIndex(rows, tp.default_mesh(CPU8), dtype=torch.int32)
        qp16 = tp.QueryParallelIndex(rows, tp.default_mesh(CPU8), dtype=torch.bfloat16)
        check(qp16.knn_dot(rows[:4], 3),
              jp.QueryParallelIndex(rows, dtype=jnp.bfloat16).knn_dot(rows[:4], 3), True)
        assert qp16.memory_bytes() < qp.memory_bytes()


class TestGridIndex:
    @pytest.mark.parametrize("qg,cs", [(2, 4), (4, 2), (1, 8), (8, 1)])
    def test_integer_dot_bit_for_bit(self, rng, qg, cs):
        rows, qs = int_rows(rng, 500, 32), int_rows(rng, 13, 32)
        got = tp.GridIndex(rows, tp.grid_mesh(cs, qg, CPU8)).knn_dot(qs, 6)
        check(got, jp.GridIndex(rows, jp.grid_mesh(cs, qg)).knn_dot(qs, 6), True)

    @pytest.mark.parametrize("mode", ["l2", "cosine"])
    def test_gaussian_l2_cosine(self, rng, mode):
        rows = rng.standard_normal((400, 24)).astype(np.float32)
        qs = rng.standard_normal((7, 24)).astype(np.float32)
        got = getattr(tp.GridIndex(rows, tp.grid_mesh(2, 4, CPU8)), METHODS[mode])(qs, 5)
        want = getattr(jp.GridIndex(rows, jp.grid_mesh(2, 4)), METHODS[mode])(qs, 5)
        check(got, want, False, qs, rows)

    def test_filtered_and_ties(self, rng):
        rows, qs = int_rows(rng, 300, 8), int_rows(rng, 5, 8)
        rows[[20, 120, 220]] = 9.0
        mask = rng.random(300) < 0.5
        mask[[20, 120, 220]] = True
        gi = tp.GridIndex(rows, tp.grid_mesh(4, 2, CPU8))
        jg = jp.GridIndex(rows, jp.grid_mesh(4, 2))
        check(gi.knn_filtered(qs, 6, mask), jg.knn_filtered(qs, 6, mask), True)
        check(gi.knn_dot(qs, 8), jg.knn_dot(qs, 8), True)
        m = np.zeros(300, bool)
        m[[1, 290]] = True
        assert set(np_(gi.knn_filtered(qs, 10, m)[1]).ravel().tolist()) == {1, 290}
        assert np_(gi.knn_filtered(qs, 5, np.zeros(300, bool))[0]).shape == (5, 0)

    def test_contracts_edges_bf16_and_memory(self, rng):
        rows = int_rows(rng, 40, 16)
        with pytest.raises(tt.ContractError):
            tp.grid_mesh(5, 5, CPU8)
        with pytest.raises(tt.ContractError):
            tp.GridIndex(rows, tp.default_mesh(CPU8))
        gm = tp.grid_mesh(2, 2, CPU8)
        assert gm.axis_names == ("queries", "shards") and gm.shape == {"queries": 2,
                                                                      "shards": 2}
        gi = tp.GridIndex(rows, gm)
        assert gi.memory_bytes() == 40 * 16 * 4  # one device: each shard held once
        assert np_(gi.knn_dot(rows[:3], 0)[0]).shape == (3, 0)
        assert np_(gi.knn_dot(rows[:2], 999)[1]).shape == (2, 40)
        with pytest.raises(tt.ContractError):
            gi.knn_dot(rows[0], 3)
        g16 = tp.GridIndex(rows, gm, dtype=torch.bfloat16)
        check(g16.knn_dot(rows[:5], 4),
              jp.GridIndex(rows, jp.grid_mesh(2, 2), dtype=jnp.bfloat16).knn_dot(rows[:5], 4),
              True)
        assert g16.memory_bytes() < gi.memory_bytes()


class TestHierarchicalMerge:
    @pytest.mark.parametrize("mode", ["dot", "l2", "cosine"])
    @pytest.mark.parametrize("slices,per", [(4, 2), (2, 4)])
    def test_equals_the_flat_merge_bit_for_bit(self, rng, mode, slices, per):
        rows, qs = int_rows(rng, 1100, 16), int_rows(rng, 3, 16)
        hc = tp.HierarchicalCorpus(rows, tp.hierarchical_mesh(slices, per, CPU8))
        sc = tp.ShardedCorpus(rows, tp.default_mesh(CPU8))
        for k in (1, 9, 400):
            check(getattr(hc, METHODS[mode])(qs, k), getattr(sc, METHODS[mode])(qs, k), True)
        if mode != "cosine":
            jh = jp.HierarchicalCorpus(rows, mesh=jp.hierarchical_mesh(slices, per))
            check(getattr(hc, METHODS[mode])(qs, 9), getattr(jh, METHODS[mode])(qs, 9), True)

    def test_ties_resolve_to_the_lowest_index_across_slices(self, rng):
        rows = int_rows(rng, 800, 16)
        q = int_rows(rng, 1, 16)[0]
        for pos in (5, 205, 405, 605):  # one per slice at (4, 2) x 100 rows
            rows[pos] = 9 * np.sign(q)
        hc = tp.HierarchicalCorpus(rows, tp.hierarchical_mesh(4, 2, CPU8))
        assert list(np_(hc.knn_dot(q, 3)[1])) == [5, 205, 405]

    def test_nan_rows_cross_slices(self, rng):
        rows = rng.standard_normal((800, 16)).astype(np.float32)
        rows[250] = np.nan
        rows[650] = np.nan
        q = rng.standard_normal(16).astype(np.float32)
        hc = tp.HierarchicalCorpus(rows, tp.hierarchical_mesh(4, 2, CPU8))
        vals, idx = hc.knn_dot(q, 5)
        assert list(np_(idx)[:2]) == [250, 650] and np.isnan(np_(vals)[:2]).all()
        flat = tp.ShardedCorpus(rows, tp.default_mesh(CPU8)).knn_dot(q, 5)
        check((vals, idx), flat, True)
        jv, ji = jp.HierarchicalCorpus(rows, mesh=jp.hierarchical_mesh(4, 2)).knn_dot(q, 5)
        np.testing.assert_array_equal(np_(idx), np.asarray(ji))

    def test_mesh_contracts_and_few_rows(self, rng):
        with pytest.raises(tt.ContractError):
            tp.HierarchicalCorpus(int_rows(rng, 10, 8), tp.default_mesh(CPU8))
        with pytest.raises(tt.ContractError):
            tp.hierarchical_mesh(3, devices=CPU8)
        mesh = tp.hierarchical_mesh(2, devices=CPU8)
        assert mesh.shape == {"dcn": 2, "ici": 4}
        # The second slice is empty and the first holds fewer than k rows
        # (the JAX class asserts k candidates a slice there).
        rows, qs = int_rows(rng, 5, 8), int_rows(rng, 2, 8)
        check(tp.HierarchicalCorpus(rows, mesh).knn_l2(qs, 5),
              tp.ShardedCorpus(rows, tp.default_mesh(CPU8)).knn_l2(qs, 5), True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
class TestOnCuda:
    def test_two_by_two_meshes_equal_the_single_card_call(self, cuda_device):
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        rows = torch.randn((30_001, 64), generator=gen, device=cuda_device)
        qs = torch.randn((9, 64), generator=gen, device=cuda_device)
        vb = tt.VerticalBatch(rows)
        four = [cuda_device] * 4
        for index in (tp.GridIndex(rows, tp.grid_mesh(2, 2, four)),
                      tp.HierarchicalCorpus(rows, tp.hierarchical_mesh(2, 2, four)),
                      tp.QueryParallelIndex(rows, tp.default_mesh(four))):
            for mode in ("dot", "l2", "cosine"):
                v, i = getattr(index, METHODS[mode])(qs, 10)
                want = FULL[mode](qs, vb, 10)
                np.testing.assert_array_equal(i.cpu().numpy(), want.indices)
                assert same_bits(v.cpu().numpy(), want.scores), (type(index), mode)
