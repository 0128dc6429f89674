"""The program's own spans in a traced window: the ``svtpu.*``
``record_function`` spans of ``svtpu_torch`` (``utils/profiling.span``), as
``tracing.Summary.host`` holds them (start, end, name; microseconds on the
trace's clock), clipped to the window.

Every function returns None where the window holds no program span (a
program that records none): nothing to read, never 0.
"""
from __future__ import annotations

from portbench import tracing

PREFIX = "svtpu."
REQUEST = "svtpu.pipeline.run_frames"
CAPTURE = "svtpu.graph.capture"
WAIT = ".wait"


def program_spans(h) -> list | None:
    """The program's spans that overlap the window, clipped to it, as
    ``(start, end, name)``; None where there are none."""
    s = h.trace_summary
    if s is None:
        return None
    out = [(max(a, s.lo), min(b, s.hi), name) for a, b, name in s.host
           if name.startswith(PREFIX) and a <= s.hi and b >= s.lo]
    return out or None


def total_ms(spans: list, name: str) -> float:
    return sum(t - s for s, t, n in spans if n == name) / 1e3


def per_step_ms(h, name: str) -> float | None:
    """Milliseconds in the spans named ``name`` over the train steps
    completed in the window."""
    spans, steps = program_spans(h), h.work.get("steps", 0)
    if spans is None or not steps:
        return None
    return total_ms(spans, name) / steps


def per_request_ms(h, name: str) -> float | None:
    """Milliseconds in the spans named ``name`` over the requests (the
    ``run_frames`` spans) in the window."""
    spans = program_spans(h)
    requests = [x for x in spans or () if x[2] == REQUEST]
    if not requests:
        return None
    return total_ms(spans, name) / len(requests)


def host_ms(h) -> float | None:
    """A request's own serial host time: each ``run_frames`` span less the
    union of the ``*.wait`` spans inside it (where the host blocked on the
    card), averaged over the requests in the window, in milliseconds."""
    spans = program_spans(h)
    requests = [x for x in spans or () if x[2] == REQUEST]
    if not requests:
        return None
    own = 0.0
    for rs, rt, _ in requests:
        waits = [(max(s, rs), min(t, rt)) for s, t, n in spans
                 if n.endswith(WAIT) and s < rt and t > rs]
        own += (rt - rs) - tracing.covered(waits)
    return own / len(requests) / 1e3


def captures(h) -> int | None:
    """The CUDA graph captures that started in the window: 0 where the
    program's spans are there and no capture is among them."""
    if program_spans(h) is None:
        return None
    lo, hi = h.trace_summary.lo, h.trace_summary.hi
    return sum(1 for s, _, n in h.trace_summary.host
               if n == CAPTURE and lo <= s <= hi)
