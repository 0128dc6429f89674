"""Share of the first rank's traced window covered by NCCL's kernels (the
union of their intervals): the gradient all-reduce and the metrics'
means."""


def read(h):
    s = h.trace_summary
    if s is None:
        return None
    share = s.share(lambda label, cat, full: cat == "kernel"
                    and "nccl" in full.lower())
    return 100.0 * share if share > 0 else None
