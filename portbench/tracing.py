"""The device's side of a traced window, from the Chrome trace that
``torch.profiler`` writes.

A copy of ``trace_breakdown`` of the port's smoke script, kept here so that
the program cannot change the yardstick: device events are those of the
"kernel", "gpu_memcpy" and "gpu_memset" categories; busy time is the union
of their intervals. The window is the span of the harness's own
``WINDOW_SPAN`` annotation, and device events are clipped to it.
"""
from __future__ import annotations

import bisect
import json
from pathlib import Path

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def kernel_label(name: str) -> str:
    """A device event's name without its template and argument lists."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        name = name.split(stop)[0]
    return name[:72]


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged intervals."""
    out: list[list[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def covered(intervals) -> float:
    return sum(t - s for s, t in union(intervals))


class Summary:
    """Device intervals of one window (microseconds on the trace's clock),
    with what the host was running."""

    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("name") == WINDOW_SPAN]
        if not spans:
            raise ValueError(f"trace: no {WINDOW_SPAN!r} span")
        w = max(spans, key=lambda e: float(e["dur"]))
        self.lo = float(w["ts"])
        self.hi = self.lo + float(w["dur"])
        self.device = []    # (start, end, label, category, full name)
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            s = max(float(e["ts"]), self.lo)
            t = min(float(e["ts"]) + float(e["dur"]), self.hi)
            if t > s:
                full = e.get("name", "?")
                label = kernel_label(full) if e["cat"] == "kernel" else full
                self.device.append((s, t, label, e["cat"], full))
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("name", "?")) for e in events
            if e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN)
        self._busy = union((s, t) for s, t, *_ in self.device)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self._busy) / 1e6

    def share(self, pred) -> float:
        """The share of the window covered by device events that ``pred``
        (of label, category, full name) accepts; 0 when none match."""
        return covered((s, t) for s, t, lab, cat, full in self.device
                       if pred(lab, cat, full)) / (self.hi - self.lo)

    def launches(self, label: str) -> tuple[int, float]:
        """Count and summed seconds of the device events named ``label``
        (in any namespace)."""
        hits = [t - s for s, t, lab, *_ in self.device
                if lab.rsplit("::", 1)[-1] == label]
        return len(hits), sum(hits) / 1e6

    def top_ops(self, n: int) -> list:
        """The ``n`` device operations (by label) that took most time."""
        by: dict[str, float] = {}
        for s, t, lab, *_ in self.device:
            by[lab] = by.get(lab, 0.0) + (t - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int) -> list:
        """The ``n`` longest stretches of the window with no device event,
        each named by the innermost host operation that spans its middle."""
        edges = [self.lo] + [x for iv in self._busy for x in iv] + [self.hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        starts = [h[0] for h in self.host]
        out = []
        for dur, s, t in gaps:
            mid = 0.5 * (s + t)
            best = None
            for hs, ht, name in self.host[:bisect.bisect_right(starts, mid)]:
                if ht >= mid and (best is None or ht - hs < best[0]):
                    best = (ht - hs, name)
            out.append([f"host: {best[1] if best else 'no operation'}",
                        dur / 1e6])
        return out


def summarize(path: Path) -> Summary:
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    return Summary(events)
