"""Shared by the readers: which device ops are the port's CUDA kernels."""


def is_kernel(name: str, patterns) -> bool:
    """Whether ``name`` matches a pattern of any ``kernels/*.json``."""
    return any(p.search(name) for pats in patterns.values() for p in pats)


def device_us(r, kernels: bool) -> float:
    """Device microseconds in the traced window of the ops that are (or
    are not) the port's kernels."""
    return sum(e - s for name, s, e in r.device_ops
               if is_kernel(name, r.kernel_patterns) == kernels)
