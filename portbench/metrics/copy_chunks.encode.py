"""The chunks in which a request's frames went to the card: the
host-to-card copies (the trace's "Memcpy HtoD" device events) in the traced
window over the ``svtpu.pipeline.run_frames`` spans in it. Counted over the
window, not matched request by request: over a window the trace's device
clock drifts against its host clock by tens of microseconds, enough to
place a request's first or last copy beside its span (the encode cells'
requests lie whole in the window). Nothing to read where the window holds
no request (a program without the span) or no copy."""
from portbench import spans


def copies_per_request(h) -> float | None:
    requests = [x for x in spans.program_spans(h) or ()
                if x[2] == spans.REQUEST]
    if not requests:
        return None
    copies = sum(1 for _, _, _, cat, full in h.trace_summary.device
                 if cat == "gpu_memcpy" and "HtoD" in full)
    return copies / len(requests) if copies else None


def read(h):
    return copies_per_request(h)
