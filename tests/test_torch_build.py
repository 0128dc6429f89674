"""The kernel builder's cache key (no ``nvcc`` needed): a library is named
by its source and every shared header, so editing either rebuilds it."""
import ctypes
import shutil

from svtpu_torch.ops import _build


def _copy_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_every_source_is_listed_and_shares_a_header():
    names = {p.stem for p in _build.SRC_DIR.glob("*.cu")}
    assert names == set(_build.SOURCES)
    assert list(_build.SRC_DIR.glob("*.cuh"))
    for name in ("flash_attention", "fused_conv01"):
        assert '#include "tensor_core.cuh"' in (
            _build.SRC_DIR / f"{name}.cu").read_text()


def test_editing_a_header_renames_every_target(tmp_path, monkeypatch):
    src = _copy_sources(tmp_path, monkeypatch)
    before = {n: _build._target(n) for n in _build.SOURCES}
    assert before == {n: _build._target(n) for n in _build.SOURCES}
    header = src / "tensor_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    assert all(p.parent == tmp_path / "build" for p in after.values())


def test_editing_a_source_renames_only_its_target(tmp_path, monkeypatch):
    src = _copy_sources(tmp_path, monkeypatch)
    before = {n: _build._target(n) for n in _build.SOURCES}
    cu = src / "fused_conv01.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert after["fused_conv01"] != before["fused_conv01"]
    assert all(after[n] == before[n] for n in _build.SOURCES
               if n != "fused_conv01")


def test_nvcc_command_targets_sm_90a_and_reports_usage(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    args = _build._nvcc_cmd("fused_conv01", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in args
    assert "-v" in args and args[-1].endswith("fused_conv01.cu")


def test_the_fused_lstm_sampler_is_built_and_shares_the_sampler_header():
    assert "lstm_binary_concrete" in _build.SOURCES
    for name in ("binary_concrete", "lstm_binary_concrete"):
        assert '#include "binary_concrete.cuh"' in (
            _build.SRC_DIR / f"{name}.cu").read_text()


def test_signatures_are_bound_once_per_loaded_library(monkeypatch):
    """``load`` sets an exported function's restype and argtypes when it
    first loads the library, and a later call leaves them alone."""
    class Fn:
        pass

    class Lib:
        def __init__(self, path):
            self.path, self.svt_fn = path, Fn()

    loaded = []
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all", lambda names: {})
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or Lib(path))
    sig = {"svt_fn": (ctypes.c_int, [ctypes.c_void_p])}
    lib = _build.load("binary_concrete", sig)
    assert lib.svt_fn.restype is ctypes.c_int
    assert lib.svt_fn.argtypes == [ctypes.c_void_p]
    lib.svt_fn.argtypes = "untouched"
    assert _build.load("binary_concrete", sig) is lib
    assert lib.svt_fn.argtypes == "untouched" and len(loaded) == 1
