"""queries_per_s: the queries answered by the window's calls over the time
from the window's start to the end of its last call (a closed loop's
window closes when that call ends)."""


def read(rec):
    if not rec.calls:
        return None
    return sum(c.n for c in rec.calls) / (rec.window.t_end - rec.window.t0)
