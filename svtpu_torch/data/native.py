"""ctypes bindings to the native IO library, the port's counterpart of
``svtpu/data/native.py``.

The library is first-party C++ for the host, not CUDA:
``native/src/svtpu_io.cpp`` holds a libav video reader (RGB24 frames) and a
multi-threaded libjpeg batch decoder that fills a contiguous uint8 NHWC
buffer with a fused bilinear resize. The port compiles that source where it
lies, with ``g++ -O3 -fPIC -std=c++17 -shared`` and the link line of
``native/Makefile``, into ``build/svtpu_torch/libsvtpu_io-<hash>.so`` at the
repo root (``build/`` is git-ignored; the hash of the source names the
library, so an edited source is rebuilt), and loads only the library it
built itself.

Only an explicit request builds: ``build()``, ``VideoReader``,
``decode_jpeg_batch`` (which ``FrameStore(decoder="native")`` and the
``native`` frame backend call) or ``python -m svtpu_torch.data.native``.
``available()`` loads an already-built library and never builds one, so the
``auto`` choices (``FrameStore(decoder="auto")``, ``run_video``) take the
native decoder only once it has been built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "src" / "svtpu_io.cpp"
MAKEFILE = _ROOT / "native" / "Makefile"
BUILD_DIR = _ROOT / "build" / "svtpu_torch"

_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "svtpu_vr_open": (ctypes.c_void_p, [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double)]),
    "svtpu_vr_next": (ctypes.c_int, [ctypes.c_void_p, _U8P]),
    "svtpu_vr_read_batch": (ctypes.c_int, [ctypes.c_void_p, _U8P,
                                           ctypes.c_int]),
    "svtpu_vr_close": (None, [ctypes.c_void_p]),
    "svtpu_jpeg_decode_batch": (ctypes.c_int, [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _U8P, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]),
}

# Loaded libraries by path: a library built into another directory (a
# test's) never makes ``available()`` true for this one.
_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(out_dir=None) -> Path:
    """Where ``build(out_dir)`` writes the library: named by the hash of
    the source, under ``out_dir`` or ``BUILD_DIR``."""
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return Path(out_dir or BUILD_DIR) / f"libsvtpu_io-{digest}.so"


def link_libs() -> list[str]:
    """``native/Makefile``'s ``LDLIBS``, the libraries the source links."""
    m = re.search(r"^LDLIBS\s*=\s*(.+)$", MAKEFILE.read_text(), re.M)
    if m is None:
        raise RuntimeError(f"no LDLIBS line in {MAKEFILE}")
    return m.group(1).split()


def build(out_dir=None) -> Path:
    """Compile the library unless it is built already; returns its path.

    A failed build raises with the compiler's output."""
    out = library_path(out_dir)
    with _lock:
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared",
                     "-o", str(tmp), str(SOURCE), *link_libs()],
                    capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError("g++ not found: the native IO library "
                                   "is built with g++") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building {out.name} failed (g++ exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    return out


def _load(build_if_missing: bool = False) -> ctypes.CDLL:
    """The bound library under ``BUILD_DIR``; built first when asked,
    else ``FileNotFoundError`` where it is not built."""
    path = library_path()
    with _lock:
        lib = _libs.get(path)
    if lib is not None:
        return lib
    if not path.exists():
        if not build_if_missing:
            raise FileNotFoundError(
                f"{path} is not built; build it with `python -m "
                f"svtpu_torch.data.native`")
        build()
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in _SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    with _lock:
        return _libs.setdefault(path, lib)


def available() -> bool:
    """Whether the library is built and loads; never builds it."""
    try:
        _load()
        return True
    except (FileNotFoundError, OSError):
        return False


class VideoReader:
    """Sequential RGB24 frame reader over the native libav decoder (builds
    the library if it is not built)."""

    def __init__(self, path: str):
        lib = _load(build_if_missing=True)
        w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        fps = ctypes.c_double()
        self._h = lib.svtpu_vr_open(str(path).encode(), ctypes.byref(w),
                                    ctypes.byref(h), ctypes.byref(n),
                                    ctypes.byref(fps))
        if not self._h:
            raise IOError(f"native reader cannot open {path}")
        self._lib = lib
        self.width, self.height = w.value, h.value
        self.num_frames = n.value
        self.fps = fps.value

    def __iter__(self) -> Iterator[np.ndarray]:
        buf = np.empty((self.height, self.width, 3), np.uint8)
        ptr = buf.ctypes.data_as(_U8P)
        while True:
            r = self._lib.svtpu_vr_next(self._h, ptr)
            if r == 0:
                return
            if r < 0:
                raise IOError(f"native decode error {r}")
            yield buf.copy()

    def read_batch(self, max_frames: int,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Up to ``max_frames`` frames in one call → ``[n, H, W, 3]`` (n is
        short at the end of the video, 0 past it)."""
        shape = (max_frames, self.height, self.width, 3)
        if out is None:
            out = np.empty(shape, np.uint8)
        elif out.shape != shape or out.dtype != np.uint8 \
                or not out.flags.c_contiguous:
            raise ValueError(f"out must be a contiguous uint8 {shape} array")
        n = self._lib.svtpu_vr_read_batch(self._h, out.ctypes.data_as(_U8P),
                                          max_frames)
        if n < 0:
            raise IOError(f"native decode error {n}")
        return out[:n]

    def close(self):
        if self._h:
            self._lib.svtpu_vr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_jpeg_batch(paths: Sequence[str | Path], resolution,
                      out: Optional[np.ndarray] = None,
                      threads: int = 0) -> np.ndarray:
    """Decode JPEGs into ``[N, H, W, 3]`` uint8 on a C++ thread pool
    (``threads`` 0: one a core), DCT-domain prescale and bilinear resize to
    ``resolution`` (H, W) inside the library (builds it if it is not
    built)."""
    lib = _load(build_if_missing=True)
    h, w = resolution
    n = len(paths)
    if out is None:
        out = np.empty((n, h, w, 3), np.uint8)
    if out.shape != (n, h, w, 3) or out.dtype != np.uint8 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be a contiguous uint8 {(n, h, w, 3)} "
                         f"array")
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    ok = lib.svtpu_jpeg_decode_batch(arr, n, out.ctypes.data_as(_U8P), h, w,
                                     threads)
    if ok != n:
        raise IOError(f"decoded {ok}/{n} JPEGs")
    return out


if __name__ == "__main__":
    print(build())
