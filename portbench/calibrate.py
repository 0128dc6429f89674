#!/usr/bin/env python3
"""The readings the output check's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 101,102,... --control-seeds 201,202,203 \
        [--run KIND:301,302,303 ...] [--out FILE]

A four-card cell runs under ``torch.distributed.run --nproc-per-node=4``.

For each seed, one run of the cell in this process with the program in
place (the lower readings), and for each control seed one run with the
control in its place: the plain reference one precision below the
configuration's (the upper readings). Each ``--run KIND:SEEDS`` adds runs
of another kind: a fault the harness plants (``half_batch``, ``noise_off``,
``noise_x2``; see ``Harness``), ``no_exchange`` (the program with the
gradients' exchange between the ranks left out), ``bf16`` (the reference
in the configuration's own bfloat16 in the program's place, a witness of
what that precision alone reads) or ``kernels_off`` (the program with its
hand-written kernel routes off). Each run's compared numbers, its
end-to-end metrics and its notes go to ``--out`` as one JSON line, and a
summary (each kind's smallest and largest reading of each number) to
standard output. The benchmark's own runs never call this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--run", action="append", default=[],
                    help="KIND:SEED,SEED,...")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from portbench.harness import BENCH_DIR, Harness, load_module
    from svtpu_torch.parallel import distributed

    own_group = distributed.initialize()
    main_rank = not dist.is_initialized() or dist.get_rank() == 0

    runs = [(int(s), "program") for s in args.seeds.split(",") if s] + \
        [(int(s), "control") for s in args.control_seeds.split(",") if s]
    for spec in args.run:
        kind, seeds = spec.split(":")
        runs += [(int(s), kind) for s in seeds.split(",") if s]
    out = open(args.out, "a") if args.out and main_rank else None
    exchange = distributed.all_reduce_mean_
    readings: dict = {}
    for seed, kind in runs:
        # A fault planted in the program: the gradients' exchange between
        # the ranks left out.
        distributed.all_reduce_mean_ = (lambda *a, **k: None) \
            if kind == "no_exchange" else exchange
        control = {"control": True, "bf16": "bf16"}.get(kind, False)
        fault = kind if kind in ("half_batch", "noise_off", "noise_x2") \
            else None
        sizes = {"config": {"model": {"pallas_trunk": False,
                                      "pallas_sampler": False}}} \
            if kind == "kernels_off" else None
        h = Harness(args.workload, seed, args.seconds, False,
                    time.perf_counter(), control=control, fault=fault,
                    sizes=sizes)
        driver = load_module(BENCH_DIR / "drivers" / f"{h.cell['driver']}.py",
                             f"portbench_driver_{h.cell['driver']}")
        driver.run(h)
        res = h.result()
        if res is None:
            continue
        line = {"workload": args.workload, "seed": seed, "kind": kind,
                "checks": res["checks"], "metrics": res["metrics"],
                "correct": res["correct"], "notes": h.notes,
                "peak_bytes": h.peak_bytes}
        print(json.dumps({k: line[k] for k in ("seed", "kind", "checks",
                                                "correct")}), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        for name, c in res["checks"].items():
            readings.setdefault((name, kind), []).append(c["value"])
        for n in h.notes:
            if n.startswith("not compared: "):
                name, value = n.split()[2:4]
                readings.setdefault((name, kind), []).append(float(value))
    for (name, kind), vals in sorted(readings.items()):
        print(f"{name} {kind} min {min(vals)!r} max {max(vals)!r} over "
              f"{len(vals)} seeds: {vals}")
    if own_group:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
