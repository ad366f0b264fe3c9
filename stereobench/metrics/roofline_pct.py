"""The route's share of its roofline: its least time per pair (the sum
over its stages of max(bytes / HBM rate, ops / unit rate), ``workmodel``
at the cell's shapes) over the device's busy time per pair in the traced
window.  It counts the functions' work, whatever implements each stage."""

LAYER = "route on the device"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "pairs_per_s"


def read(r):
    if not r.least_s_per_pair or not r.pairs or not r.busy_us:
        return None
    return 100.0 * r.least_s_per_pair / (r.busy_us / 1e6 / r.pairs)
