"""``volume_ms`` in the online cells, where it moves their own end-to-end
metric (``metrics/volume_ms.py`` reads it)."""

from stereobench.metrics.volume_ms import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

MOVES = "online_pairs_per_s"
