"""serving.pad_share.serve: the share of the rows the MicroBatcher launched
that were padding, over the window's windows: sum(bucket - n) / sum(bucket)
of the port's ``batcher.window`` spans. Reports nothing where the program
has no span log."""


def read(rec):
    from gpubench.metrics._spans import window_spans

    spans = window_spans(rec)
    if spans is None:
        return None
    wins = [s.attrs for s in spans if s.name == "batcher.window"]
    rows = sum(a["bucket"] for a in wins)
    return sum(a["bucket"] - a["n"] for a in wins) / rows if rows else None
