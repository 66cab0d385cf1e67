"""kernel.k1_rescored_share.batch: the share of K1's (row, query) pairs that
its gate sent to the exact re-score, over the window's passes: the sum of
the ``rescored`` device counters of the port's ``dispatch.k1_pass`` spans
(read once, after the window) over the sum of their ``rows`` x ``n_q``.
Reports nothing where the program has no span log or no pass ran on the
card."""


def read(rec):
    import torch

    from gpubench.metrics._spans import window_spans

    spans = window_spans(rec)
    if spans is None:
        return None
    passes = [s.attrs for s in spans if s.name == "dispatch.k1_pass" and "rescored" in s.attrs]
    if not passes:
        return None
    by_device = {}
    for a in passes:
        by_device.setdefault(a["rescored"].device, []).append(a["rescored"].reshape(1))
    pairs = sum(int(torch.cat(c).sum()) for c in by_device.values())
    return pairs / sum(a["rows"] * a["n_q"] for a in passes)
