"""The benchmark of innr_tpu_torch, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix, one metric,
one index kind or one loop is a file of its own, found by name
(:mod:`gpubench.bench`): ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (one reader each), ``gen/<generator>.py``,
``systems/<index>.py`` (the container under test), ``references/<index>.py``
(a kind's own plain reference, where it has one) and ``loops/<loop>.py``.
Nothing here imports ``jax`` or the JAX package ``innr_tpu``, and the plain
reference (``reference.py``) imports nothing of ``innr_tpu_torch``.
"""
