"""``tail_ms`` in the online cells, where it moves their own end-to-end
metric (``metrics/tail_ms.py`` reads it)."""

from stereobench.metrics.tail_ms import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

MOVES = "online_pairs_per_s"
