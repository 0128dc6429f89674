"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each ``svtpu_torch/csrc/<name>.cu`` has a plain C interface and is compiled
on its own by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/svtpu_torch/lib<name>-<hash>.so`` at the repo
root (``build/`` is git-ignored); the hash of the source and of the shared
headers (``csrc/*.cuh``) names the library, so an edited source or header
is rebuilt and a built one is reused. Nothing here runs
at import: the CPU tests import every module, and there is no ``nvcc`` there.

Every exported launcher returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception, so a refused launch
(too much shared memory, a bad grid) never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "svtpu_torch"
SOURCES = ("binary_concrete", "flash_attention", "fused_conv01",
           "group_norm_silu", "lstm_binary_concrete", "window_attention")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of svtpu_torch are "
                       "built with the CUDA toolkit's nvcc")


def _target(name: str) -> Path:
    """The library's path, named by the hash of its source and of every
    shared header in ``csrc/``, so that editing a header rebuilds too."""
    h = hashlib.sha1((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc_cmd(name: str, out: Path) -> list[str]:
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(SRC_DIR / f"{name}.cu")]


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every out-of-date source, one ``nvcc`` per source, all
    started together. Returns each compiler's output (register and shared
    memory use from ``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, signatures=None) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built if needed.

    ``signatures`` maps an exported function's name to its ``(restype,
    argtypes)``; they are set once, when the library is first loaded, and
    not on every call.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (restype, argtypes) in (signatures or {}).items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def plain(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a plain tensor whose ``data_ptr`` holds its values, for a
    launcher, which reads memory by address past PyTorch's dispatch. A
    tensor subclass is materialised by an op that is not a view: the
    local output of a tensor-parallel layer is an ``AsyncCollectiveTensor``
    whose collective may not have run, and whose wrapper has no storage of
    its own (its address made the LSTM kernel read out of bounds on a
    (2, 2) mesh). Raises for a subclass that stays one (a ``DTensor``)."""
    if type(t) is torch.Tensor:
        return t
    out = t.clone()
    if type(out) is not torch.Tensor:
        raise TypeError(f"the kernels take plain tensors, got "
                        f"{type(t).__name__}")
    return out


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a launcher's stream
    argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
