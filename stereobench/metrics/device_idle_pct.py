"""The device's idle share of the traced window: 1 - (union of its
kernel, copy and fill intervals) / the window, which the host's clock
times from the first request's issue to the last one's completion.  The
trace records the device's activity alone, so the host issues at its
untraced pace."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "pairs_per_s"


def read(r):
    if not r.window_us or not r.device_ops:
        return None
    return 100.0 * (1.0 - r.busy_us / r.window_us)
