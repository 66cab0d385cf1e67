"""serving.queue_wait_ms.serve: the median, over the window's requests, of the
time from a request's submission to the MicroBatcher to the start of its
window's backend call (the port's spans: a ``batcher.window``'s
``submit_ns`` stamps to the start of its ``batcher.scan`` child), in ms.
Reports nothing where the program has no span log."""

import numpy as np


def read(rec):
    from gpubench.metrics._spans import children, window_spans

    spans = window_spans(rec)
    if spans is None:
        return None
    scan = children(spans, "batcher.scan")
    waits = [scan[w.id] - t for w in spans if w.name == "batcher.window" and w.id in scan
             for t in w.attrs.get("submit_ns", ()) if t]
    return float(np.median(waits)) / 1e6 if waits else None
