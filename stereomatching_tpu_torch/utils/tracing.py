"""The port's spans and counters: where a forward spends its host time
and its device time, stage by stage, and what it launched.

Tracing is on while a ``torch.profiler`` session is active (the flag
torch sets when a session starts) and after an explicit ``enable()``
until ``disable()``.  Off, every site costs one flag read: no clock
read, no allocation, no CUDA event.  Each new session starts a new
buffer; a session's start and end are seen at the next root span's
entry (or at ``records()``).

**Spans.**  ``span(name, like)`` opens a span: a root, which opens a new
request, or a child of the span open on this thread.  ``stage(name)``
ends the open span's current stage, if any, and begins the next, so
that consecutive stages share their boundary.  Each span records its
name, its parent, its request, and its host start and end in ns from
``time.time_ns()``, the clock of the profiler's own host events.  On
CUDA inputs it also records timing ``torch.cuda.Event``s on the current
stream at its boundaries (pooled, one event a boundary), resolved only
when the records are read, after the caller has synchronised.  A stage's device ms is the time from the
stream reaching its start event to reaching its end event.

**Counters**, of the current request: ``launches.<K>`` (CUDA kernel
launches, counted in each kernel wrapper), ``host_sync`` (blocking reads
on a forward path) and ``plain_stage.<stage>`` (a kernel-backed stage
the config sends to its plain torch version).

Records stay in memory, at most ``DEFAULT_CAPACITY`` spans a session;
beyond it ``dropped`` counts the spans not kept.  ``records()`` reads
them without clearing them.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

DEFAULT_CAPACITY = 1 << 17

_explicit = False
# Whether the buffer belongs to the session now running.
_live = False
_local = threading.local()
# Free timing events, by CUDA device index.
_pool: Dict[int, List[torch.cuda.Event]] = {}


class _Span:
    __slots__ = ("id", "name", "parent", "request", "stream", "pairs", "t0", "t1", "e0",
                 "e1", "root", "stage", "out")

    def __init__(self, sid, name, parent, request, stream, pairs, root):
        self.id, self.name, self.parent, self.request = sid, name, parent, request
        self.stream, self.pairs, self.root = stream, pairs, root
        self.t0 = self.t1 = self.e0 = self.e1 = self.stage = self.out = None


class _Buffer:
    def __init__(self):
        self.spans: List[_Span] = []
        self.requests: List[Dict] = []
        self.dropped = 0


_buf = _Buffer()


def on() -> bool:
    """Whether tracing is on: an explicit ``enable()`` or a profiler
    session."""
    return _explicit or _profiler._is_profiler_enabled


def enable() -> None:
    """Turn tracing on until ``disable()``, in a new buffer."""
    global _explicit, _live
    _new_buffer()
    _explicit = _live = True


def disable() -> None:
    """End an ``enable()`` session; its records stay readable."""
    global _explicit, _live
    _explicit = _live = False


def clear() -> None:
    """Drop every record."""
    global _live
    _new_buffer()
    _live = False


def _new_buffer() -> None:
    global _buf
    _buf = _Buffer()
    _local.stack = []


def _stack() -> List[_Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _boundary(stream) -> tuple:
    """(host ns, event or None) of one boundary: a timing event recorded on
    ``stream``, from the pool of its device."""
    t = time.time_ns()
    if stream is None:
        return t, None
    free = _pool.get(stream.device_index)
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return t, ev


class _Open:
    """The context of one span while tracing is on."""

    __slots__ = ("name", "like", "span")

    def __init__(self, name: str, like: Optional[torch.Tensor]):
        self.name, self.like, self.span = name, like, None

    def __enter__(self):
        global _live
        if not _live:
            _new_buffer()
            _live = True
        stack = _stack()
        parent = stack[-1] if stack else None
        if parent is None:
            like = self.like
            stream = (torch.cuda.current_stream(like.device)
                      if like is not None and like.is_cuda else None)
            pairs = int(like.shape[0]) if like is not None and like.ndim == 3 else 1
            request = len(_buf.requests)
            _buf.requests.append({"request": request, "counters": {}})
        else:
            stream, pairs, request = parent.stream, parent.pairs, parent.request
        s = _Span(len(_buf.spans), self.name, parent, request, stream, pairs,
                  parent.root if parent is not None else None)
        if s.root is None:
            s.root = s
        s.t0, s.e0 = _boundary(stream)
        _keep(s)
        stack.append(s)
        self.span = s
        return s

    def __exit__(self, *exc):
        s = self.span
        stack = _stack()
        if stack and stack[-1] is s:
            stack.pop()
        t, ev = _boundary(s.stream)
        _close(s.stage, t, ev)
        s.stage = None
        _close(s, t, ev)
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _keep(s: _Span) -> None:
    """Keep ``s`` in the buffer, unless the buffer is full or its parent
    was not kept."""
    if len(_buf.spans) < DEFAULT_CAPACITY and (s.parent is None or s.parent.id is not None):
        _buf.spans.append(s)
    else:
        s.id = None
        _buf.dropped += 1


def _close(s: Optional[_Span], t: int, ev) -> None:
    if s is not None:
        s.t1, s.e1 = t, ev


def span(name: str, like: Optional[torch.Tensor] = None):
    """A context manager timing one span: a root (a new request) when no
    span is open on this thread, else a child of the open one.  ``like``,
    for a root: a tensor of the request, whose device is where device
    time is taken (none on the CPU) and whose leading dimension, when it
    is 3-D, is the request's number of pairs."""
    global _live
    if not on():
        _live = False
        return _NULL
    return _Open(name, like)


def stage(name: str) -> None:
    """End the open span's current stage and begin stage ``name`` at the
    same boundary; nothing outside a span."""
    if not on():
        return
    stack = _stack()
    if not stack:
        return
    parent = stack[-1]
    t, ev = _boundary(parent.stream)
    _close(parent.stage, t, ev)
    s = _Span(len(_buf.spans), name, parent, parent.request, parent.stream, parent.pairs,
              parent.root)
    s.t0, s.e0 = t, ev
    _keep(s)
    parent.stage = s


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the current request (nothing
    outside a span)."""
    if not on():
        return
    stack = _stack()
    if not stack:
        return
    req = _buf.requests[stack[-1].request]
    req["counters"][name] = req["counters"].get(name, 0) + n


def _resolve(s: _Span) -> Dict:
    """The record of a closed span, its events resolved (after the caller
    has synchronised, the wait is none)."""
    out = {"id": s.id, "name": s.name, "parent": None if s.parent is None else s.parent.id,
           "request": s.request, "host_start_ns": s.t0, "host_end_ns": s.t1,
           "device_ms": None, "device_start_ms": None}
    if s.parent is None:
        out["pairs"] = s.pairs
    if s.e0 is not None and s.e1 is not None:
        s.e1.synchronize()
        out["device_ms"] = s.e0.elapsed_time(s.e1)
        out["device_start_ms"] = s.root.e0.elapsed_time(s.e0)
    return out


def records() -> Dict:
    """The session's records, without clearing them: ``spans`` (dicts of
    ``id``, ``name``, ``parent`` (an id or None), ``request``,
    ``host_start_ns``, ``host_end_ns``, ``device_ms`` and
    ``device_start_ms``, the latter from the request's root start event,
    None off CUDA; a root also has ``pairs``), in the order they opened,
    closed ones only; ``requests`` (dicts of ``request`` and
    ``counters``); ``dropped``."""
    global _live
    if not on():
        _live = False
    spans = [s for s in _buf.spans if s.t1 is not None]
    for s in spans:
        if s.out is None:
            s.out = _resolve(s)
    # Events of resolved spans go back to the pool once no open span
    # still measures from them (a request's root start event).
    if not _stack():
        freed = set()
        for s in spans:
            for ev in (s.e0, s.e1):
                if ev is not None and id(ev) not in freed:
                    freed.add(id(ev))
                    _pool.setdefault(s.stream.device_index, []).append(ev)
            s.e0 = s.e1 = None
    return {"spans": [s.out for s in spans], "requests": list(_buf.requests),
            "dropped": _buf.dropped}
