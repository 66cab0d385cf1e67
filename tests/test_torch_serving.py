"""innr_tpu_torch.MicroBatcher against direct batched calls and innr_tpu.

Every wait carries a timeout (``Future.result(timeout=...)``, joins with a
timeout), so a hang fails in seconds instead of eating the run's limit.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from innr_tpu import serving as jserving  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch import serving as tserving  # noqa: E402
from innr_tpu_torch.kernels import _build  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


WAIT = 20.0
D = 8


def corpus(rng, n=300):
    return rng.integers(-3, 4, (n, D)).astype(np.float32)


@pytest.mark.parametrize("max_batch", [1, 3, 8, 32])
def test_bucket_ladder_equals_the_jax_package(max_batch):
    for n in range(1, max_batch + 1):
        assert tserving._bucket(n, max_batch) == jserving._bucket(n, max_batch)


def test_bucket_pads_17_of_32_to_24():
    assert tserving._bucket(17, 32) == 24 and tserving._bucket(32, 32) == 32


def run_threads(target, n_threads):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)


class TestBackends:
    def test_segmented_corpus_from_16_threads(self, rng):
        sc = tt.SegmentedCorpus(D, auto_compact=False)
        sc.add(corpus(rng, 200))
        sc.add(corpus(rng, 150))
        sc.delete([3, 250])
        qs = corpus(rng, 48)
        want_s, want_i = sc.knn_dot(qs, 5)
        got = [None] * len(qs)
        with tt.MicroBatcher(sc, k=5, max_batch=8, max_wait_ms=5.0) as mb:
            def worker(t):
                for i in range(t, len(qs), 16):
                    got[i] = mb.search(qs[i], timeout=WAIT)
            run_threads(worker, 16)
            stats = mb.stats
        for i, (s, idx) in enumerate(got):
            np.testing.assert_array_equal(idx, want_i[i])
            np.testing.assert_array_equal(s.view(np.int32), want_s[i].view(np.int32))
        assert stats.requests == len(qs) and stats.launches >= len(qs) // 8
        assert sum(stats.batch_histogram.values()) == stats.launches
        assert set(stats.batch_histogram) <= {1, 2, 4, 6, 8}
        assert stats.mean_batch == len(qs) / stats.launches

    def test_ivf_index_search_batch(self, rng):
        rows = corpus(rng, 600)
        index = tt.IVFIndex(rows, n_clusters=4, metric="l2", n_iters=2)
        qs = corpus(rng, 6)
        want = index.search_batch(qs, 4)
        with tt.MicroBatcher(index, k=4, max_batch=4, max_wait_ms=1.0) as mb:
            futures = [mb.submit(q) for q in qs]
            got = [f.result(timeout=WAIT) for f in futures]
        for i, (s, idx) in enumerate(got):
            np.testing.assert_array_equal(idx, want.indices[i])
            np.testing.assert_array_equal(s, want.scores[i])

    def test_callables_of_one_and_two_arguments_returning_tensors(self, rng):
        rows = torch.from_numpy(corpus(rng))
        vb = tt.VerticalBatch(rows)
        qs = corpus(rng, 5)

        def two(q, k):
            res = tt.batch_knn_dot(q, vb, k)
            return torch.from_numpy(res.scores), torch.from_numpy(res.indices).to(torch.int32)

        want = tt.batch_knn_dot(qs, vb, 3)
        for backend in (two, lambda q: two(q, 3)):
            with tt.MicroBatcher(backend, k=3, max_batch=2, max_wait_ms=1.0) as mb:
                got = [mb.search(torch.from_numpy(q), timeout=WAIT) for q in qs]
            for i, (s, idx) in enumerate(got):
                assert isinstance(s, np.ndarray) and s.dtype == np.float32
                np.testing.assert_array_equal(idx, want.indices[i])
                np.testing.assert_array_equal(s, want.scores[i])

    def test_padding_repeats_the_first_query(self):
        seen = []

        def backend(qs):
            seen.append(np.array(qs))
            return np.zeros((len(qs), 1), np.float32), np.arange(len(qs))[:, None]

        mb = tt.MicroBatcher(backend, k=1, max_batch=8, max_wait_ms=50.0, pipeline_depth=1)
        futures = [mb.submit(np.full(D, i, np.float32)) for i in range(5)]
        assert [f.result(timeout=WAIT)[1][0] for f in futures] == [0, 1, 2, 3, 4]
        mb.close()
        # 5 waiting of max_batch 8: the ladder's quarter step above 4 is 6.
        assert len(seen) == 1 and seen[0].shape == (6, D)
        assert (seen[0][5:] == seen[0][0]).all()
        assert mb.stats.batch_histogram == {6: 1}

    def test_backend_contract(self):
        with pytest.raises(tt.ContractError, match="backend"):
            tt.MicroBatcher(object(), k=1)
        for kw in ({"k": 0}, {"k": 1, "max_batch": 0}, {"k": 1, "pipeline_depth": 0}):
            with pytest.raises(tt.ContractError):
                tt.MicroBatcher(lambda q: q, **kw)


class TestFailuresAndLifecycle:
    def test_an_exception_reaches_every_caller_of_the_window(self):
        def backend(qs):
            raise RuntimeError("backend down")

        with tt.MicroBatcher(backend, k=2, max_batch=4, max_wait_ms=20.0) as mb:
            futures = [mb.submit(np.zeros(D, np.float32)) for _ in range(4)]
            for f in futures:
                with pytest.raises(RuntimeError, match="backend down"):
                    f.result(timeout=WAIT)
            assert mb.stats.requests == 0

    def test_close_drains_then_refuses(self, rng):
        sc = tt.SegmentedCorpus(D)
        sc.add(corpus(rng, 50))
        mb = tt.MicroBatcher(sc, k=2, max_batch=16, max_wait_ms=200.0)
        futures = [mb.submit(q) for q in corpus(rng, 3)]
        mb.close()
        assert all(f.result(timeout=WAIT)[1].shape == (2,) for f in futures)
        assert not mb._collector.is_alive()
        with pytest.raises(tt.ContractError, match="closed"):
            mb.submit(np.zeros(D, np.float32))
        with tt.MicroBatcher(sc, k=1) as other:
            with pytest.raises(tt.ContractError, match="1-D"):
                other.submit(np.zeros((2, D), np.float32))

    def test_build_and_load_hold_one_lock(self, monkeypatch):
        """Two threads' first kernel calls build once: the second waits for
        the first's library instead of running nvcc on the same files."""
        calls, release = [], threading.Event()

        def fake_build():
            calls.append(threading.get_ident())
            release.wait(timeout=WAIT)
            return "lib"

        monkeypatch.setattr(_build, "_build", fake_build)
        monkeypatch.setattr(_build, "_LIB", None)
        monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
        monkeypatch.setattr(_build, "_declare", lambda lib: setattr(_build, "_LIB", lib))
        results = []
        threads = [threading.Thread(target=lambda: results.append(_build.load()))
                   for _ in range(2)]
        for t in threads:
            t.start()
        release.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert results == ["lib", "lib"] and len(calls) == 1


def test_counters_survive_contention():
    """More client threads than cores and a short interpreter switch
    interval: every request is answered with its own row, and the stats
    (updated under the batcher's lock) lose no update."""
    import os
    import sys

    def backend(qs):
        return qs[:, :1].copy(), (qs[:, :1] * 10).astype(np.int64)

    n_threads = max(32, 4 * (os.cpu_count() or 1))
    per_thread = 10
    wrong = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with tt.MicroBatcher(backend, k=1, max_batch=8, max_wait_ms=1.0) as mb:
            def worker(t):
                for j in range(per_thread):
                    v = float(t * per_thread + j)
                    s, i = mb.search(np.full(D, v, np.float32), timeout=WAIT)
                    if s[0] != v or i[0] != int(v * 10):
                        wrong.append((t, j))
            run_threads(worker, n_threads)
            stats = mb.stats
    finally:
        sys.setswitchinterval(old)
    assert wrong == []
    assert stats.requests == n_threads * per_thread
    assert sum(stats.batch_histogram.values()) == stats.launches
