"""The device's idle share of the traced window while the host is inside
the program's ``forward``: the root spans' device us (from the tracer's
events) less the busy union of the program's device ops, over the window.
It holds in a closed loop of one request in flight, the online cells
(``metrics/_spans.py`` says why).  The rest of ``device_idle_pct`` falls
between forwards, while the host waits, checksums and calls again."""

from stereobench.metrics import _spans

LAYER = "pipeline entry"
UNIT = "%"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "online_pairs_per_s"


def read(r):
    return _spans.issue_idle_pct(r)
