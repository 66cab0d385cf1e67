"""kernel.k1_roofline.batch: the batch window's calls' bound over K1's device
time on every card, in percent."""

from gpubench.record import k1_roofline_pct


def read(rec):
    return k1_roofline_pct(rec)
