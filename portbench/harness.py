"""One run of one cell: the window, its clocks, its trace, its checks and
the result line.

A driver (``drivers/<kind>.py``) builds the program, warms it up and calls
``Harness.open_window``; it runs the cell's traffic until
``Harness.window_over`` says the window's seconds are spent, then calls
``close_window``, reads the peak memory (``read_peak``), frees the program
and hands each number it compared to ``compare``. The harness turns that
into the result line: the end-to-end metrics with ``--trace 0``, the
per-layer metrics (one reader a metric, ``metrics/<name>.py``) with
``--trace 1``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from portbench import tracing

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Modules the process may not hold once the window has closed: JAX and the
# JAX package the port was made from, by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "svtpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark_json() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, found by its name (names
    hold dots, so they are loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(workload: str) -> tuple[dict, dict]:
    """The cell's workload file and its configuration's file."""
    cell = load_json(BENCH_DIR / "workloads" / f"{workload}.json")
    config = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    return cell, config


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_line() -> str:
    """The cards' names and power limits, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.replace("\n", "; ")


class Harness:
    """The clocks, the trace and the checks of one run.

    ``device``: where the program runs ("cuda" on the card; the CPU tests
    pass "cpu"). ``sizes``: overrides of the cell's traffic, limits and
    configuration, for the CPU tests and the calibration's witnesses only.
    ``control``: put the reference, in the precision below the
    configuration's, in the program's place (True: the control that the
    limits were set against; ``"bf16"``: the reference in the
    configuration's own bfloat16, a witness). ``fault``: a fault planted
    for the readings it gives: ``"half_batch"``, the reference in the
    program's place with a train step that leaves out half of its batch;
    ``"noise_off"`` and ``"noise_x2"``, the encode cells' noisy pipeline
    with its noise off or its noise scale doubled.
    """

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, t_start: float, device: str = "cuda",
                 sizes: dict | None = None, control: bool | str = False,
                 fault: str | None = None):
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_start = t_start
        self.device = torch.device(device)
        self.cell, self.config = cell_files(workload)
        sizes = sizes or {}
        for part, into in (("traffic", self.cell["traffic"]),
                           ("limits", self.cell["limits"])):
            into.update(sizes.get(part, {}))
        for key, value in sizes.get("config", {}).items():
            self.config[key].update(value)
        self.control = control
        self.fault = fault
        self.chips = int(self.cell["chips"])
        # Under a launcher each card is one rank; the first prints.
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.e2e: dict[str, float] = {}
        self.work: dict[str, float] = {}
        self.checks: list[dict] = []
        self.attempted = 0
        self.failed = 0
        self.notes: list[str] = []
        self.peak_bytes = 0
        self.t0 = self.t1 = None
        self._prof = None
        self._window_span = None
        self._tmp = None
        self.trace_summary = None

    # ---------------------------------------------------------------- window

    def note(self, line: str) -> None:
        """A line for standard error, printed before the result."""
        self.notes.append(line)
        print(line, file=sys.stderr, flush=True)

    def open_window(self) -> None:
        """Set-up ends here: every shape the window uses has run."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.trace:
            self._tmp = tempfile.TemporaryDirectory(prefix="portbench-")
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._window_span = torch.profiler.record_function(
                tracing.WINDOW_SPAN)
            self._window_span.__enter__()
        self.t0 = time.perf_counter()
        self.e2e["setup_s"] = self.t0 - self.t_start

    def window_over(self) -> bool:
        """Whether the window's seconds are spent; across ranks, as the
        first rank's clock says (every rank must call it in step)."""
        over = time.perf_counter() - self.t0 >= self.seconds
        if self.world == 1:
            return over
        flag = torch.tensor([float(over)], device=self._comm_device())
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def _comm_device(self):
        return self.device if dist.get_backend() == "nccl" \
            else torch.device("cpu")

    def _gather(self, value: float) -> list:
        """``value`` of every rank (a collective)."""
        if self.world == 1:
            return [value]
        out = [None] * self.world
        dist.all_gather_object(out, value)
        return out

    def close_window(self) -> float:
        """Ends the window once its work is done on the device; returns its
        length in seconds."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        if self._prof is not None:
            self._window_span.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            path = Path(self._tmp.name) / "trace.json"
            self._prof.export_chrome_trace(str(path))
            self._prof = None
            self.trace_summary = tracing.summarize(path)
            path.unlink()
            self._tmp.cleanup()
            # The cards' mean busy time; the first rank's trace otherwise.
            busy = self._gather(self.trace_summary.busy_s)
            self.busy_s = sum(busy) / len(busy)
        return self.t1 - self.t0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def read_peak(self) -> None:
        """The peak of the fullest card since the process began, set-up and
        its graphs' pools included, before the reference runs (a
        collective across ranks)."""
        if self.device.type == "cuda":
            own = torch.cuda.max_memory_allocated(self.device)
            self.peak_bytes = max(self._gather(own))

    # ---------------------------------------------------------------- checks

    def compare(self, name: str, value: float, limit: float) -> None:
        """One number of the output check: ``value`` must not exceed
        ``limit`` (a value that is not a number fails)."""
        ok = isinstance(value, (int, float)) and math.isfinite(value) \
            and value <= limit
        self.checks.append({"name": name, "value": float(value),
                            "limit": float(limit), "ok": bool(ok)})

    @property
    def limits(self) -> dict:
        return self.cell["limits"]

    # ---------------------------------------------------------------- result

    def per_layer(self) -> dict:
        """Each per-layer metric of BENCHMARK.json that lists this cell,
        read by its own reader; a reader that finds nothing returns None
        and the metric is left out."""
        out = {}
        for m in benchmark_json()["per_layer"]:
            if self.workload not in m["workloads"]:
                continue
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name']}")
            value = reader.read(self)
            if value is None:
                self.note(f"per-layer metric {m['name']}: nothing to read")
                continue
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    def result(self) -> dict | None:
        """The result line's object; None on every rank but the first."""
        if self.rank != 0:
            return None
        units = {m["name"]: m["unit"]
                 for m in benchmark_json()["end_to_end"]}
        if self.trace:
            metrics = self.per_layer()
        else:
            metrics = {k: {"value": float(v), "unit": units[k]}
                       for k, v in self.e2e.items()}
        device = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(self.device)
                           if self.device.type == "cuda" else "cpu"),
                  "count": self.chips, "memory_peak_bytes": self.peak_bytes}
        out = {"correct": bool(self.checks)
               and all(c["ok"] for c in self.checks) and self.failed == 0,
               "attempted": int(self.attempted), "failed": int(self.failed),
               "metrics": metrics, "device": device}
        if self.trace and self.trace_summary is not None:
            s = self.trace_summary
            device["busy_s"] = self.busy_s
            device["window_s"] = s.window_s
            out["breakdown"] = {"device_ops": s.top_ops(10),
                                "idle_gaps": s.idle_gaps(10)}
        out["checks"] = {c["name"]: {"value": c["value"],
                                     "limit": c["limit"]}
                         for c in self.checks}
        return out
