"""Micro-batching serving layer: coalesce single-query requests into one
batched search.

The counterpart of :mod:`innr_tpu.serving`. A K1 scan reads the corpus once
for the whole batch, so a caller that sends one query at a time pays a
corpus read per query; concurrent callers coalesced into one batch share
it. :class:`MicroBatcher` wraps any batched search backend. Concurrent
callers block in :meth:`~MicroBatcher.search` (or get a ``Future`` from
:meth:`~MicroBatcher.submit`); a collector thread gathers requests until
``max_batch`` are waiting or the oldest has waited ``max_wait_ms``, then
hands the window to a flush worker: one batched search for the window,
every caller woken with its own row of the result, an exception delivered
to every caller of the window.

``pipeline_depth`` flush workers (default 2) let the next window collect
and launch while the previous one runs and copies its result back.

Windows are padded with copies of their first query up to a bucket
(:func:`_bucket`: powers of two, then quarter steps of ``max_batch``), as
in the JAX package, where each bucket is one compiled XLA program. The
CUDA kernels take any batch size, so here the ladder only keeps
``stats.batch_histogram`` comparable with the JAX package's; what padding
costs on the card is measured in ``chip_smoke.py`` (``PERF.md``).

Results are numpy arrays; a backend that returns tensors has them copied to
the host in one copy of the stacked (scores, indices) pair per window.

While a profiler records (:mod:`innr_tpu_torch.utils.trace`), each window is
a ``batcher.window`` span on its flush worker (``n`` requests, ``bucket``
rows, the requests' ``submit_ns`` stamps), with the children
``batcher.scan`` (the backend call) and ``batcher.deliver`` (the results
handed out). Its parent is the span that was open where the window's first
request was submitted.
"""

from __future__ import annotations

import inspect
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from innr_tpu_torch.utils import trace as _trace
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.tensors import to_host

__all__ = ["MicroBatcher", "BatcherStats"]


@dataclass
class BatcherStats:
    """Counters of the serving layer: requests answered, searches launched
    and windows per padded batch size."""

    requests: int = 0
    launches: int = 0
    batch_histogram: dict = field(default_factory=dict)

    @property
    def mean_batch(self) -> float:
        return self.requests / self.launches if self.launches else 0.0


class _Request:
    __slots__ = ("query", "future", "t_ns", "parent")

    def __init__(self, query):
        self.query = query
        self.future = Future()
        self.t_ns = 0  # submitted at, on perf_counter_ns; stamped while tracing
        self.parent = None  # the submitter's innermost open span


def _bucket(n: int, max_batch: int) -> int:
    """Smallest padded size >= n on the bucket ladder, capped at
    ``max_batch``: powers of two up to ``max_batch / 2``, then quarter
    steps of ``max_batch`` (a 17-query window on max_batch=32 pads to 24)."""
    b = 1
    while b < n and b < max_batch // 2:
        b *= 2
    if b >= n:
        return min(b, max_batch)
    step = max(max_batch // 4, 1)
    while b < n:
        b += step
    return min(b, max_batch)


def _host_query(query) -> np.ndarray:
    if isinstance(query, torch.Tensor):
        query = query.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(query, dtype=np.float32)


class MicroBatcher:
    """Coalesces concurrent single-query searches into batched searches.

    ``backend``: an object with ``search_batch(queries, k)`` returning a
    ``BatchKnnResult`` (:class:`~innr_tpu_torch.pipeline.TwoStageIndex`,
    :class:`~innr_tpu_torch.ivf.IVFIndex`), an object with
    ``knn_dot(queries, k)`` returning ``(values, indices)``
    (:class:`~innr_tpu_torch.segmented.SegmentedCorpus`), or a callable
    ``f(queries)`` or ``f(queries, k)`` returning ``(values (Q, k),
    indices (Q, k))``, numpy arrays or tensors.

    ``k``: neighbours per query (fixed per batcher). ``max_batch``: flush
    when this many requests wait (also the largest bucket). ``max_wait_ms``:
    flush when the oldest waiting request is this old. Use as a context
    manager or call :meth:`close`; ``search`` is safe from any number of
    threads.
    """

    def __init__(self, backend, k: int, max_batch: int = 32,
                 max_wait_ms: float = 2.0, pipeline_depth: int = 2):
        if k < 1:
            raise ContractError("MicroBatcher: k must be >= 1")
        if max_batch < 1:
            raise ContractError("MicroBatcher: max_batch must be >= 1")
        if pipeline_depth < 1:
            raise ContractError("MicroBatcher: pipeline_depth must be >= 1")
        self.k = int(k)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._scan = self._make_scan(backend)
        self.stats = BatcherStats()
        self._lock = threading.Condition()
        self._queue: list[_Request] = []
        self._oldest_t = 0.0
        self._closed = False
        self._depth = int(pipeline_depth)
        self._pool = ThreadPoolExecutor(max_workers=self._depth,
                                        thread_name_prefix="innr-torch-microbatcher-flush")
        self._inflight = 0
        self._collector = threading.Thread(target=self._collect_loop,
                                           name="innr-torch-microbatcher", daemon=True)
        self._collector.start()

    @staticmethod
    def _make_scan(backend):
        if hasattr(backend, "search_batch"):
            return lambda qs, k, _b=backend: _b.search_batch(qs, k)
        if hasattr(backend, "knn_dot"):
            return lambda qs, k, _b=backend: _b.knn_dot(qs, k)
        if callable(backend):
            try:
                n_params = sum(
                    1 for p in inspect.signature(backend).parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                    and p.default is p.empty)
            except (TypeError, ValueError):  # builtins without signatures
                n_params = 1
            if n_params >= 2:
                return backend  # f(queries, k)
            return lambda qs, k, _b=backend: _b(qs)
        raise ContractError(
            "MicroBatcher: backend must expose search_batch(queries, k), "
            "knn_dot(queries, k), or be callable(queries)")

    # -- caller side --------------------------------------------------------

    def submit(self, query) -> Future:
        """Non-blocking single-query search: a ``Future`` resolving to
        ``(values (k,), indices (k,))`` numpy arrays. Coalesces with
        concurrent callers."""
        q = _host_query(query)
        if q.ndim != 1:
            raise ContractError(f"MicroBatcher.search: query must be 1-D, got {q.shape}")
        req = _Request(q)
        if _trace.on():
            req.t_ns = time.perf_counter_ns()
            req.parent = _trace.current_id()
        with self._lock:
            if self._closed:
                raise ContractError("MicroBatcher: closed")
            if not self._queue:
                self._oldest_t = time.monotonic()
            self._queue.append(req)
            self._lock.notify_all()
        return req.future

    def search(self, query, timeout: float | None = 30.0):
        """Blocking single-query search: ``(values (k,), indices (k,))``
        numpy arrays."""
        return self.submit(query).result(timeout)

    # -- collector side -----------------------------------------------------

    def _collect_loop(self):
        while True:
            with self._lock:
                while not self._closed:
                    if len(self._queue) >= self.max_batch:
                        break
                    if self._queue:
                        wait = self._oldest_t + self.max_wait_s - time.monotonic()
                        # Every flush worker busy: keep collecting (a bigger
                        # window serves more callers per search); workers
                        # notify when they finish.
                        if wait <= 0 and self._inflight < self._depth:
                            break
                        self._lock.wait(timeout=self.max_wait_s)
                    else:
                        self._lock.wait()
                if self._closed and not self._queue:
                    return
                window = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
                if self._queue:
                    self._oldest_t = time.monotonic()
                self._inflight += 1
            self._pool.submit(self._flush, window)

    def _flush(self, window):
        try:
            n = len(window)
            bucket = _bucket(n, self.max_batch)
            with _trace.span("batcher.window", parent=window[0].parent, n=n,
                             bucket=bucket) as span:
                if _trace.on():
                    span.set(submit_ns=[r.t_ns for r in window])
                qs = np.stack([r.query for r in window]
                              + [window[0].query] * (bucket - n))  # pad rows are dropped
                with _trace.span("batcher.scan"):
                    res = self._scan(qs, self.k)
                with _trace.span("batcher.deliver"):
                    vals, idx = self._normalize(res)
                    for i, r in enumerate(window):
                        r.future.set_result((vals[i], idx[i]))
            with self._lock:
                self.stats.requests += n
                self.stats.launches += 1
                self.stats.batch_histogram[bucket] = self.stats.batch_histogram.get(bucket, 0) + 1
        except Exception as e:  # noqa: BLE001 — delivered to each caller
            for r in window:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            with self._lock:
                self._inflight -= 1
                self._lock.notify_all()

    @staticmethod
    def _normalize(res):
        """``(values, indices)`` numpy arrays from a backend's result: one
        host copy of the pair when it returns tensors."""
        if hasattr(res, "indices"):  # BatchKnnResult
            return np.asarray(res.scores), np.asarray(res.indices)
        vals, idx = res
        if isinstance(vals, torch.Tensor) and isinstance(idx, torch.Tensor):
            return to_host(vals.to(torch.float32), idx.to(vals.device))
        return np.asarray(vals), np.asarray(idx)

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        """Drain pending requests, stop the collector and the flush workers."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._collector.join(timeout=60.0)
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
