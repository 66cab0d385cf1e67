"""device.idle_share.serve: the share of the traced window in which no
kernel, copy or memset ran on the card (interval union)."""

from gpubench.record import idle_share


def read(rec):
    return idle_share(rec)
