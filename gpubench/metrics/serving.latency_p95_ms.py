"""serving.latency_p95_ms: the 95th percentile, over every request of the
traced window, of the time from its due time to its answer on the host (a
failed request counts as waiting until the run gave up on it). The tail of
the serve cells swings with the host's stalls from run to run, so it is read
per layer, beside the end-to-end median."""

from gpubench.record import percentile_ms


def read(rec):
    return percentile_ms(rec, 95)
