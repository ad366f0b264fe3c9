"""Device milliseconds per pair of the torch ops: every op of the traced
window (kernels, copies, fills) whose name no ``kernels/*.json`` pattern
matches, less the benchmark's own checksum kernels."""

from stereobench.metrics._kernels import device_us

LAYER = "torch ops"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "pairs_per_s"


def read(r):
    us = device_us(r, kernels=False) - r.checksum_us
    if not r.pairs or us <= 0:
        return None
    return us / 1e3 / r.pairs
