"""Shared by the readers of the program's own spans: the records of the
port's tracer (``stereomatching_tpu_torch/utils/tracing.py``).  The
traced segment runs under ``torch.profiler``, which turns the tracer on,
so the records read after it are that segment's requests.  A program
without the tracer, one that never loaded it (the control), or a run on
the CPU gives no spans with device time, and the readers read nothing.

The readers use the spans' device times alone, from the tracer's CUDA
events, and need no host clock on the trace's.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

from stereobench.harness import CHECKSUM_KERNEL, union_us

TRACER = "stereomatching_tpu_torch.utils.tracing"
ROOT = "forward"


def program_records() -> Optional[Dict]:
    """The tracer's records, or None where the program did not load it."""
    tracing = sys.modules.get(TRACER)
    return None if tracing is None else tracing.records()


def roots(recs: Optional[Dict]) -> List[Dict]:
    """The ``forward`` root spans, in the order they opened."""
    if not recs:
        return []
    return [s for s in recs["spans"] if s["parent"] is None and s["name"] == ROOT]


def stage_ms(stage: str) -> Optional[float]:
    """Device ms per pair of the ``forward`` stage ``stage``: its device
    ms summed over the traced requests that ran it, over their pairs."""
    recs = program_records()
    by_id = {s["id"]: s for s in roots(recs)}
    ms = pairs = 0
    for s in recs["spans"] if by_id else ():
        if s["name"] == stage and s["parent"] in by_id and s["device_ms"] is not None:
            ms += s["device_ms"]
            pairs += by_id[s["parent"]]["pairs"]
    return ms / pairs if pairs else None


def issue_idle_pct(r) -> Optional[float]:
    """% of the traced window in which the device is idle while the host
    is inside a ``forward`` root span (``idle_in_roots_us``)."""
    idle = idle_in_roots_us(r, program_records())
    if idle is None or not r.window_us:
        return None
    return 100.0 * idle / r.window_us


def idle_in_roots_us(r, recs: Optional[Dict]) -> Optional[float]:
    """Device-idle us while the host is inside a ``forward`` root span, in
    a closed loop of one request in flight: the roots' device us less the
    busy union of the program's device ops (all but the checksum's).

    A root's device time runs from the stream reaching its start event to
    reaching its end event.  The host records the start event on entry,
    after it saw the request before complete, so the idle stream reaches
    it at once; every op of the request is queued behind it, and the
    checksum behind the end event, which the stream reaches once the last
    op has run.  So each root's device interval holds its request's ops
    and no other, and is idle only while the host has yet to issue them."""
    device_ms = [s["device_ms"] for s in roots(recs) if s["device_ms"] is not None]
    ops = [(s, e) for name, s, e in r.device_ops if not CHECKSUM_KERNEL.search(name)]
    if not device_ms or not ops:
        return None
    busy, _ = union_us(ops)
    return 1e3 * sum(device_ms) - busy
