"""Ops of the classic pipeline: plain torch phases and the two kernel
wrappers (``fused``, ``fused_diffusion``)."""
