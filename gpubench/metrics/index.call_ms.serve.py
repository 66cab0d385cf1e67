"""index.call_ms.serve: the median host-clock span of the backend call that
the benchmark hands the MicroBatcher, from its start to its result on the
host."""

import numpy as np


def read(rec):
    if not rec.calls:
        return None
    return float(np.median([(c.end - c.start) * 1e3 for c in rec.calls]))
