"""``enqueue_ms`` in the online cells, where it moves their own end-to-end
metric (``metrics/enqueue_ms.py`` reads it)."""

from stereobench.metrics.enqueue_ms import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

MOVES = "online_latency_ms_p95"
