"""innr_tpu_torch.distance and the backend report against innr_tpu.

Each metric's ``eval`` and ``eval_batch`` on the same numpy inputs in both
packages: float metrics within 1e-5 relative (sums in different orders),
the Hamming and slot metrics exactly; ``eval_batch`` equals ``eval`` row by
row. Slots are drawn over the full 32 bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu as it  # noqa: E402
import innr_tpu_torch as itt  # noqa: E402
from innr_tpu import distance as jd  # noqa: E402
from innr_tpu_torch import backend, config, distance as td  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


FLOAT_METRICS = ["DistCosine", "DistDot", "DistL2", "DistL1"]


def inputs(rng, name, n=20):
    if name == "DistHamming":
        return (rng.integers(0, 256, 16, dtype=np.uint8),
                rng.integers(0, 256, (n, 16), dtype=np.uint8))
    if name == "DistSlotU32":
        rows = rng.integers(0, 4, (n, 32)).astype(np.uint32) * np.uint32(0x9E3779B1)
        return rows[3].copy(), rows
    return (rng.standard_normal(24).astype(np.float32),
            rng.standard_normal((n, 24)).astype(np.float32))


class TestMetrics:
    @pytest.mark.parametrize("name", FLOAT_METRICS + ["DistHamming", "DistSlotU32"])
    def test_eval_and_batch_against_jax(self, rng, name):
        q, rows = inputs(rng, name)
        mine, theirs = getattr(td, name)(), getattr(jd, name)()
        got = mine.eval_batch(q, rows)
        want = np.asarray(theirs.eval_batch(q, rows))
        assert got.dtype == torch.float32 and tuple(got.shape) == (rows.shape[0],)
        exact = name in ("DistHamming", "DistSlotU32")
        if exact:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        for r in range(3):
            one = mine.eval(q, rows[r])
            assert float(one) == pytest.approx(float(theirs.eval(q, rows[r])), rel=1e-5,
                                               abs=0 if exact else 1e-5)
            assert float(one) == pytest.approx(float(got[r]), rel=1e-5, abs=1e-5)

    def test_default_eval_batch_is_eval_per_row(self, rng):
        class Neg(td.Distance):
            def eval(self, a, b):
                return -itt.dot(a, b)

        q, rows = inputs(rng, "DistDot", 6)
        got = Neg().eval_batch(q, rows)
        assert torch.equal(got, torch.stack([-itt.dot(q, r) for r in rows]))

    def test_known_values(self):
        assert float(td.DistCosine().eval([1.0, 0.0], [2.0, 0.0])) == pytest.approx(0.0, abs=1e-7)
        assert float(td.DistDot().eval([1.0, 2.0], [3.0, 4.0])) == -11.0
        assert float(td.DistL1().eval([1.0, 2.0], [4.0, 0.0])) == 5.0
        assert float(td.DistHamming().eval(np.array([0xFF], np.uint8),
                                           np.array([0x0F], np.uint8))) == 4.0
        assert float(td.DistSlotU32().eval(np.array([1, 2, 3, 4], np.uint32),
                                           np.array([1, 2, 0, 0], np.uint32))) == 0.5

    def test_exported_names(self):
        for name in FLOAT_METRICS + ["Distance", "DistHamming", "DistSlotU32"]:
            assert getattr(itt, name) is getattr(td, name)


class TestBackend:
    def test_display_strings_stable(self):
        assert [str(b) for b in backend.Backend] == ["cuda", "torch", "reference"]

    @pytest.mark.parametrize("fn", ["dense_backend", "slot_backend"])
    def test_pair_ops_report_torch_or_reference(self, fn, monkeypatch):
        report = getattr(backend, fn)
        assert report(1) == report(4096) == backend.Backend.TORCH
        monkeypatch.setattr(config, "_FORCE_REFERENCE", True)
        assert report(128) == backend.Backend.REFERENCE
        assert str(getattr(it.backend, fn)(128)) in ("vpu", "reference")
