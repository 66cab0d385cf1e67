"""latency_p50_ms: the median, over every request of the window, of the time
from its due time to its answer on the host (a failed request counts as
waiting until the run gave up on it)."""

from gpubench.record import percentile_ms


def read(rec):
    return percentile_ms(rec, 50)
