"""One rank of a four-rank run of the train cell on the CPU (gloo), under
``torch.distributed.run``; the first rank prints the result line.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        portbench/tests/_rank.py [sound|no_exchange]
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.run import run_cell  # noqa: E402

SIZES = {"config": {"model": {"input_hw": [32, 32], "compute_dtype": "float32",
                              "pallas_trunk": False, "pallas_sampler": False},
                    "train": {"batch_size": 8}},
         "traffic": {"warm_epochs": 3}}


def main(mode: str) -> None:
    if mode == "no_exchange":
        from svtpu_torch.parallel import distributed

        distributed.all_reduce_mean_ = lambda *a, **k: None
    r = run_cell("flagship-train.4card", 2 ** 31 + 77, 0.5, False,
                 time.perf_counter(), device="cpu", sizes=SIZES)
    if r is not None:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
