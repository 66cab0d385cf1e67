"""innr_tpu_torch.parallel._scan and K1's decode against innr_tpu.parallel._scan.

The port's scan body is K1's raw keys (its plain version on the CPU); the
JAX package's fused arm is its K1 kernel, run here in interpret mode as its
own tests run it. The port decodes the keys in
``innr_tpu_torch.kernels.knn.decode_keys``, the JAX package in its
``_scan``. On integer-valued rows every score is exact, so keys, global
indices and decoded scores must agree bit for bit, L2's keys without
``||q||^2`` included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from innr_tpu.parallel import _scan as jscan  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.parallel import _scan as tscan  # noqa: E402
from innr_tpu_torch.utils.asserts import ContractError  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def data(seed, n=200, d=8, n_q=3):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-4, 5, (n, d)).astype(np.float32)
    qs = rng.integers(-3, 4, (n_q, d)).astype(np.float32)
    return rows, qs


def aux_of(mode, rows):
    r = torch.from_numpy(rows)
    if mode == "dot":
        return None, None
    a = tk._norms2(r) if mode == "l2" else tk.inv_norms(r)
    return a, jnp.asarray(a.numpy())


@pytest.mark.parametrize("mode", ["dot", "l2", "cosine"])
@pytest.mark.parametrize("base,n_total", [(0, 200), (500, 650), (1000, 1100)])
def test_local_scan_keys_and_decode_against_jax(mode, base, n_total):
    rows, qs = data(base)
    if mode == "cosine":
        qs = (qs / np.linalg.norm(qs, axis=1, keepdims=True)).astype(np.float32)
    taux, jaux = aux_of(mode, rows)
    k = 9
    tkeys, tidx = tscan.local_scan_keys(torch.from_numpy(qs), torch.from_numpy(rows), taux,
                                        n_total, k, mode, base)
    jkeys, jidx = jscan.local_scan_keys(jnp.asarray(qs), jnp.asarray(rows), jaux, n_total, k,
                                        mode, True, base)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if mode == "cosine":  # unit queries: dots round in each package's order
        live = tidx.numpy() - base < n_total - base
        tv = tk.decode_keys(tkeys, mode, torch.from_numpy(qs)).numpy()
        jv = np.asarray(jscan.decode_keys(jkeys, mode, True, jnp.asarray(qs)))
        np.testing.assert_allclose(tv[live], jv[live], rtol=0, atol=1e-6)
        return
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    tv = tk.decode_keys(tkeys, mode, torch.from_numpy(qs)).numpy()
    jv = np.asarray(jscan.decode_keys(jkeys, mode, True, jnp.asarray(qs)))
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))


def test_rows_past_n_total_are_pinned():
    rows, qs = data(3)
    keys, idx = tscan.local_scan_keys(torch.from_numpy(qs), torch.from_numpy(rows), None,
                                      150, 200, "dot", 0)
    past = idx.numpy() >= 150
    assert past.sum() == 3 * 50 and (keys.numpy()[past] == np.iinfo(np.int32).min).all()
    assert (keys.numpy()[~past] > np.iinfo(np.int32).min).all()


def test_l2_decode_adds_the_query_norm_and_clamps():
    rows = np.array([[1.0, 0.0], [0.0, 2.0]], np.float32)
    qs = np.array([[1.0, 0.0]], np.float32)
    r, q = torch.from_numpy(rows), torch.from_numpy(qs)
    keys, idx = tscan.local_scan_keys(q, r, tk._norms2(r), 2, 2, "l2")
    vals = tk.decode_keys(keys, "l2", q)
    assert idx.tolist() == [[0, 1]] and vals.tolist() == [[0.0, 5.0]]
    # The raw keys leave ||q||^2 out: norms2 - 2 q.r is -1 and 4.
    assert tk.decode_keys(~keys, "dot", q).tolist() == [[-1.0, 4.0]]


@pytest.mark.parametrize("base", [0, 300])
def test_filtered_scan_against_jax(base):
    rows, qs = data(11)
    mask = (np.arange(200) % 3 != 0).astype(np.float32)
    r = torch.from_numpy(rows)
    norms2 = tk._norms2(r)
    tkeys, tidx = tscan.local_scan_keys_filtered(torch.from_numpy(qs), r, norms2,
                                                 torch.from_numpy(mask), base + 200, 12, base)
    jkeys, jidx = jscan.local_scan_keys_filtered(
        jnp.asarray(qs), jnp.asarray(rows), jnp.asarray(norms2.numpy()), jnp.asarray(mask),
        base + 200, 12, True, base)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    assert (mask[tidx.numpy() - base] > 0).all()


def test_resolve_predicate_mask_against_jax():
    for pred in (lambda i: i % 4 == 1, np.arange(10) > 6, torch.arange(10) < 3):
        want = jscan.resolve_predicate_mask(
            pred if not isinstance(pred, torch.Tensor) else pred.numpy(), 10, "op")
        got = tscan.resolve_predicate_mask(pred, 10, "op")
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    with pytest.raises(ContractError, match="mask shape"):
        tscan.resolve_predicate_mask(np.ones(4, bool), 10, "op")
