"""device.idle_host_share.serve: the share of the traced window in which card
0 runs no kernel, copy or memset while some thread is inside one of the
port's ``index.call`` spans and not yet in its ``index.to_host``: the card
idle because the host is still issuing the call's work. The spans are
placed on the trace's clock by the window's start. Reports nothing where
the program has no span log."""


def read(rec):
    from gpubench.metrics._spans import idle_split, window_spans

    spans = window_spans(rec)
    split = None if spans is None else idle_split(rec, spans)
    return None if split is None else split["host issuing"] / rec.trace.window_s
