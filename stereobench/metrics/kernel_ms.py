"""Device milliseconds per pair of the port's CUDA kernels: every op of
the traced window whose name a ``kernels/*.json`` pattern matches."""

from stereobench.metrics._kernels import device_us

LAYER = "CUDA kernels"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "pairs_per_s"


def read(r):
    us = device_us(r, kernels=True)
    if not r.pairs or not us:
        return None
    return us / 1e3 / r.pairs
