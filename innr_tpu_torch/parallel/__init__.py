"""The distribution layer of :mod:`innr_tpu.parallel`, ported piece by piece.

Only the shared per-device scan body (:mod:`._scan`) is here so far, which
:class:`~innr_tpu_torch.segmented.SegmentedCorpus` already uses; the sharded
indexes are still to be ported (``ROADMAP.md``), so this package exports no
public name yet.
"""

__all__: list[str] = []
