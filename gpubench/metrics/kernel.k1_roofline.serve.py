"""kernel.k1_roofline.serve: the serve window's calls' bound
(``gpubench/roofline.py``, each call's real queries) over K1's device time
(``knn_scan_tc*`` and ``knn_merge`` in the trace), in percent."""

from gpubench.record import k1_roofline_pct


def read(rec):
    return k1_roofline_pct(rec)
