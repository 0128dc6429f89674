"""Share of the traced window covered by host-to-card copies (the union of
the trace's "Memcpy HtoD" intervals)."""


def read(h):
    s = h.trace_summary
    if s is None:
        return None
    share = s.share(lambda label, cat, full: cat == "gpu_memcpy"
                    and "HtoD" in full)
    return 100.0 * share if share > 0 else None
