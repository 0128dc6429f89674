#!/usr/bin/env python3
"""The benchmark of svtpu_torch, the PyTorch and CUDA port, on NVIDIA H100
cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for. One run builds the cell's inputs and weights from ``--seed``, warms up
every shape the cell uses (set-up, reported as ``setup_s``), runs the
cell's traffic for ``--seconds``, then holds a sample of what the window
produced against the plain reference under ``portbench/reference/``. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``; its per-layer metrics, read from a ``torch.profiler`` trace
of the window, with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.

Cells (``BENCHMARK.json``): each is ``portbench/workloads/<cell>.json``
(configuration, chips, traffic, limits), run by the driver its ``driver``
names (``portbench/drivers/<driver>.py``) on the configuration
``portbench/configs/<config>.json``; each per-layer metric is read by
``portbench/metrics/<metric>.py``.

  pixel-encode.hd64     1 card: 64 HD frames a request through run_frames
  flagship-train        1 card: Trainer.train of the flagship preset
  percep-encode.sd8     1 card: 8 HD frames a request, SD first stage
  flagship-train.4card  4 cards: the same training, data-parallel; this
                        process starts torch.distributed.run with one rank
                        a card, and the first rank prints the result

Files: the port builds its kernels into ``build/svtpu_torch/`` inside the
checkout (the first run of a checkout compiles them); Triton's and
Inductor's caches are pointed at ``build/portbench/``; the trace of a
``--trace 1`` run is written under ``TMPDIR`` and deleted once read.
Nothing else is written.

Exit codes: 0 with a result line; 2 without a card (or with fewer than the
cell asks for); 3 when JAX or the JAX package was loaded; any failure of
the run itself exits non-zero without a result line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, **kw) -> dict | None:
    """One run of a cell; returns the result object (None on a rank other
    than the first). ``kw``: the ``Harness``'s options (device, sizes,
    control, fault). Under a launcher the process group is started first
    and ended last."""
    import torch.distributed as dist

    from portbench.harness import BENCH_DIR, Harness, load_module
    from svtpu_torch.parallel import distributed

    own_group = distributed.initialize(device=kw.get("device", "cuda"))
    try:
        h = Harness(workload, seed, seconds, trace, t_start, **kw)
        driver = load_module(
            BENCH_DIR / "drivers" / f"{h.cell['driver']}.py",
            f"portbench_driver_{h.cell['driver']}")
        driver.run(h)
        return h.result()
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def launch(argv: list, chips: int) -> int:
    """The run again under ``torch.distributed.run``, one rank a card; the
    first rank prints the result. Set-up counts from this process's
    start."""
    import subprocess

    env = dict(os.environ, PORTBENCH_T0=repr(
        time.time() - (time.perf_counter() - T_START)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={chips}", str(Path(__file__).resolve()),
           *argv]
    return subprocess.run(cmd, env=env, cwd=ROOT).returncode


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cell_files, forbidden_modules, power_line

    cell, _ = cell_files(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    chips = int(cell["chips"])
    if chips > 1 and "LOCAL_RANK" not in os.environ:
        return launch(argv, chips)
    t_start = T_START
    if "PORTBENCH_T0" in os.environ:
        t_start -= time.time() - float(os.environ["PORTBENCH_T0"])
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start)
    if result is None:                 # a rank other than the first
        return 0
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}: the port must not "
              f"load JAX or the JAX package", file=sys.stderr)
        return 3
    print(f"card: {power_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
