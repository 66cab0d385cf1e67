"""index.host_issue_ms.serve: the median, over the window's index calls, of
the host time from a call's start to the start of the device-to-host copy
that ends it (the port's ``index.call`` span to its ``index.to_host``
child), less the time in the copy of its queries to the device (its
``index.to_device`` child): the time the host takes to enqueue the call's
device work, in ms. The queries' copy is left out because from pageable
memory it may wait for the work already queued on the stream (in
``deep100m.serve`` on an H100 it took 0.3 ms of an issue of 4-6 ms, the
K1 launch and the call's own host work). Reports nothing where the
program has no span log."""

from collections import defaultdict

import numpy as np


def read(rec):
    from gpubench.metrics._spans import children, window_spans

    spans = window_spans(rec)
    if spans is None:
        return None
    to_host = children(spans, "index.to_host")
    copy_in = defaultdict(int)
    for s in spans:
        if s.name == "index.to_device":
            copy_in[s.parent] += s.end_ns - s.start_ns
    issue = [to_host[c.id] - c.start_ns - copy_in[c.id] for c in spans
             if c.name == "index.call" and c.id in to_host]
    return float(np.median(issue)) / 1e6 if issue else None
