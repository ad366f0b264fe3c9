"""Host milliseconds from the call of the pipeline's ``forward`` to its
return, the mean over the measured window's requests: the time the host
spends issuing a request's work.  The span is the benchmark's own,
around the call."""

LAYER = "pipeline entry"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "latency_ms_p95"


def read(r):
    if not r.enqueue_s:
        return None
    return 1e3 * sum(r.enqueue_s) / len(r.enqueue_s)
