"""``device_idle_pct`` in the online cells, where it moves their own end-to-end
metric (``metrics/device_idle_pct.py`` reads it)."""

from stereobench.metrics.device_idle_pct import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

MOVES = "online_pairs_per_s"
