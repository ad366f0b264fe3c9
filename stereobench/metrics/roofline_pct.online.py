"""``roofline_pct`` in the online cells, where it moves their own end-to-end
metric (``metrics/roofline_pct.py`` reads it)."""

from stereobench.metrics.roofline_pct import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

MOVES = "online_pairs_per_s"
