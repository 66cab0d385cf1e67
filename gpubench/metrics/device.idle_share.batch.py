"""device.idle_share.batch: the same as device.idle_share.serve, in the batch
cells (over several cards, the mean of the cards)."""

from gpubench.record import idle_share


def read(rec):
    return idle_share(rec)
