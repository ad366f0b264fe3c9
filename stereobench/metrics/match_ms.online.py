"""``match_ms`` in the online cells, where it moves their own end-to-end
metric (``metrics/match_ms.py`` reads it)."""

from stereobench.metrics.match_ms import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

MOVES = "online_pairs_per_s"
