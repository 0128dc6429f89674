"""Environment report (``svtpu/utils/env_check.py``, the reference's
``scripts/version_check.ipynb`` role): versions, cards, optional packages,
the CUDA compiler, the native IO library, and a smoke test on the card.

It is a report: where there is no card it says so, and raises nothing.

    python -m svtpu_torch.utils.env_check
"""
from __future__ import annotations

import importlib
import json

import torch

OPTIONAL = ("numpy", "PIL", "cv2", "sklearn", "matplotlib", "tensorboardX",
            "triton")


def environment_report() -> dict:
    report = {"torch": torch.__version__, "cuda_runtime": torch.version.cuda,
              "cuda_available": torch.cuda.is_available()}
    report["devices"] = [torch.cuda.get_device_name(i) for i in
                         range(torch.cuda.device_count())] \
        if report["cuda_available"] else []
    for mod in OPTIONAL:
        try:
            m = importlib.import_module(mod)
            report[mod] = getattr(m, "__version__", "present")
        except ImportError:
            report[mod] = None
    from svtpu_torch.ops import _build

    try:
        report["nvcc"] = _build.nvcc_path()
    except RuntimeError:
        report["nvcc"] = None
    from svtpu_torch.data import native

    report["libsvtpu_io"] = native.available()
    if report["cuda_available"]:
        x = torch.ones((8, 8), device="cuda")
        report["device_smoke_test"] = float(x.sum()) == 64.0
    else:
        report["device_smoke_test"] = "not run: no CUDA device"
    return report


if __name__ == "__main__":
    print(json.dumps(environment_report(), indent=2))
