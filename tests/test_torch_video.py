"""The port's video slice on the CPU: the counterparts of
``tests/test_io_native.py`` (the native cases build the library into a
temporary directory, never into the tree's ``build/``), ``extract_frames``
against ``svtpu``'s, ``run_video`` against ``svtpu``'s on shared weights
(deterministic, f32, codes bit for bit), its noisy seed role, its error
handling under a time limit, the CLI's ``extract``, ``convert`` and video
``encode`` against ``svtpu.cli``'s, and the ``auto`` choices staying on
PIL / cv2 while no library is built."""
import concurrent.futures
import io
import threading

import numpy as np
import pytest

from svtpu import cli as jcli
from svtpu.config import rbvae_variant as jax_variant
from svtpu.data import frames as jframes
from svtpu.pipeline import VideoSymbolPipeline as JaxPipeline
from svtpu_torch import cli
from svtpu_torch.config import rbvae_variant
from svtpu_torch.data import native
from svtpu_torch.data.datasets import FrameStore
from svtpu_torch.data.frames import (BACKENDS, convert_video, extract_frames,
                                     iter_frames_cv2, video_info)
from svtpu_torch.models.convert import from_jax_params
from svtpu_torch.pipeline import VideoSymbolPipeline

from _torch_port import seeded_jax_params

GEOM = dict(input_hw=(32, 32), conv_features=(16, 16, 16))
LATENT = 12
# Seconds a run_video call (the port's or svtpu's, whose decode thread
# can block forever) may take before a test calls it hung.
TIME_LIMIT = 20


def _write_video(path, n, hw=(48, 64), seed=0):
    """An MJPG AVI of ``n`` frames whose brightness ramps with the frame
    index, plus seeded noise, written by cv2."""
    import cv2

    h, w = hw
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"),
                             10.0, (w, h))
    rng = np.random.default_rng(seed)
    for i in range(n):
        frame = np.full((h, w, 3), i * 20 % 200, np.uint8)
        frame += rng.integers(0, 40, frame.shape, dtype=np.uint8)
        writer.write(frame)
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def tiny_video(tmp_path_factory):
    """``tests/test_io_native.py``'s 12-frame 64x48 video."""
    import cv2

    d = tmp_path_factory.mktemp("vid")
    path = str(d / "tiny.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                        (64, 48))
    rng = np.random.default_rng(0)
    for i in range(12):
        frame = np.full((48, 64, 3), i * 20, np.uint8)
        frame += rng.integers(0, 10, frame.shape, dtype=np.uint8)
        w.write(frame)
    w.release()
    return path


@pytest.fixture(scope="module")
def video20(tmp_path_factory):
    return _write_video(tmp_path_factory.mktemp("v20") / "v.avi", 20)


@pytest.fixture(scope="module")
def native_lib_dir(tmp_path_factory):
    """A directory holding the native library, built once for the
    module."""
    d = tmp_path_factory.mktemp("native_build")
    native.build(d)
    return d


@pytest.fixture
def with_native(native_lib_dir, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", native_lib_dir)


@pytest.fixture
def without_native(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "no_build")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_variant("contrastive", LATENT, **GEOM)
    params = seeded_jax_params(jcfg, seed=4)
    tcfg = rbvae_variant("contrastive", LATENT, **GEOM)
    return jcfg, params, tcfg, from_jax_params(params, tcfg)


def _call(fn, *args, **kw):
    """``fn(*args, **kw)`` on a worker thread, failing the test if it has
    not returned within ``TIME_LIMIT`` s."""
    ex = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return ex.submit(fn, *args, **kw).result(timeout=TIME_LIMIT)
    finally:
        ex.shutdown(wait=False)


def _decode_threads():
    return [t for t in threading.enumerate()
            if t.name == "run_video-decode"]


# --- counterparts of tests/test_io_native.py


def test_extract_cv2(tiny_video, tmp_path):
    n = extract_frames(tiny_video, tmp_path / "frames", backend="cv2")
    assert n == 12
    assert (tmp_path / "frames" / "0000000000.jpg").exists()
    assert (tmp_path / "frames" / "0000000011.jpg").exists()


def test_extract_every_n_and_limit(tiny_video, tmp_path):
    assert extract_frames(tiny_video, tmp_path / "f2", backend="cv2",
                          every_n=3) == 4
    assert extract_frames(tiny_video, tmp_path / "f3", backend="cv2",
                          limit=5) == 5


def test_video_info(tiny_video):
    info = video_info(tiny_video)
    assert info["frames"] == 12
    assert (info["width"], info["height"]) == (64, 48)
    assert info == jframes.video_info(tiny_video)


def test_convert_roundtrip(tiny_video, tmp_path):
    dst = tmp_path / "out.avi"
    convert_video(tiny_video, dst)
    assert video_info(dst)["frames"] == 12


def test_unknown_backend(tiny_video, tmp_path):
    with pytest.raises(ValueError):
        extract_frames(tiny_video, tmp_path / "x", backend="nope")


def test_native_video_reader(tiny_video, with_native):
    with native.VideoReader(tiny_video) as vr:
        assert (vr.width, vr.height) == (64, 48)
        assert vr.num_frames == 12 and vr.fps == pytest.approx(10.0)
        frames = list(vr)
    assert len(frames) == 12
    assert frames[0].shape == (48, 64, 3)
    # Brightness ramps with frame index in the synthetic video.
    assert frames[-1].mean() > frames[0].mean() + 50


def test_native_jpeg_batch(tmp_path, with_native):
    from PIL import Image

    paths, imgs = [], []
    yy, xx = np.mgrid[0:40, 0:60]
    for i in range(8):
        # Smooth gradients (JPEG-friendly; random noise is worst-case lossy).
        img = np.stack([(yy * 4 + i * 10) % 256, (xx * 3) % 256,
                        ((yy + xx) * 2) % 256], -1).astype(np.uint8)
        p = tmp_path / f"{i}.jpg"
        Image.fromarray(img).save(p, quality=95)
        imgs.append(img)
        paths.append(p)
    out = native.decode_jpeg_batch(paths, (40, 60))
    assert out.shape == (8, 40, 60, 3)
    err = np.abs(out.astype(int) - np.stack(imgs).astype(int)).mean()
    assert err < 20
    assert native.decode_jpeg_batch(paths, (20, 30)).shape == (8, 20, 30, 3)
    with pytest.raises(IOError, match="decoded 8/9"):
        native.decode_jpeg_batch(paths + [tmp_path / "missing.jpg"],
                                 (20, 30))


def test_native_matches_cv2_decode(tiny_video, with_native):
    cv2_frames = list(BACKENDS["cv2"](tiny_video))
    nat_frames = list(BACKENDS["native"](tiny_video))
    assert len(cv2_frames) == len(nat_frames) == 12
    for a, b in zip(cv2_frames, nat_frames):
        assert np.abs(a.astype(int) - b.astype(int)).mean() < 5


def test_native_read_batch(tiny_video, with_native):
    with native.VideoReader(tiny_video) as vr:
        assert vr.read_batch(5).shape == (5, 48, 64, 3)
        assert vr.read_batch(100).shape == (7, 48, 64, 3)
        assert vr.read_batch(4).shape[0] == 0          # past the end
        with pytest.raises(ValueError, match="contiguous uint8"):
            vr.read_batch(3, out=np.empty((2, 48, 64, 3), np.uint8))
    with native.VideoReader(tiny_video) as vr:
        out = np.zeros((3, 48, 64, 3), np.uint8)
        got = vr.read_batch(3, out=out)
        assert got.base is out or got is out
        assert out[2].mean() > out[0].mean()


# --- the native library's build


def test_available_never_builds(without_native):
    assert not native.available()
    assert not native.library_path().exists()
    assert not native.library_path().parent.exists()


def test_build_failure_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.build(tmp_path / "out")
    assert list((tmp_path / "out").iterdir()) == []


def test_link_line_is_the_makefiles():
    assert native.link_libs() == ["-lavformat", "-lavcodec", "-lavutil",
                                  "-lswscale", "-ljpeg", "-lpthread"]


# --- extract against svtpu


def test_extract_matches_svtpu(tiny_video, tmp_path):
    """The same file names as ``svtpu``'s extract, and each file the cv2
    frame saved by PIL at quality 95, byte for byte."""
    from PIL import Image

    ours, ref = tmp_path / "ours", tmp_path / "ref"
    assert extract_frames(tiny_video, ours, every_n=2, limit=4) == \
        jframes.extract_frames(tiny_video, ref, every_n=2, limit=4) == 4
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in ref.iterdir()) == [
        f"{i:010d}.jpg" for i in (0, 2, 4, 6)]
    decoded = list(iter_frames_cv2(tiny_video))
    for name in names:
        buf = io.BytesIO()
        Image.fromarray(decoded[int(name[:-4])]).save(buf, format="JPEG",
                                                      quality=95)
        assert (ours / name).read_bytes() == (ref / name).read_bytes() \
            == buf.getvalue()


def test_extract_native_backend(tiny_video, tmp_path, with_native):
    assert extract_frames(tiny_video, tmp_path / "n", backend="native",
                          limit=3) == 3
    assert sorted(p.name for p in (tmp_path / "n").iterdir()) == [
        f"{i:010d}.jpg" for i in range(3)]


# --- run_video


@pytest.mark.parametrize("batch, limit", [(8, None), (8, 5), (6, 13)])
def test_run_video_matches_svtpu(models, video20, batch, limit):
    """Deterministic f32 codes of a 20-frame video, bit for bit: a short
    last batch (20 = 2·8 + 4), a limit inside the first batch, a limit
    that ends inside a batch."""
    jcfg, params, tcfg, sd = models
    ref = _call(JaxPipeline(jcfg, params, batch=batch, noise=False)
                .run_video, video20, limit=limit)
    got = _call(VideoSymbolPipeline(tcfg, sd, batch=batch, noise=False,
                                    device="cpu").run_video,
                video20, limit=limit)
    n = 20 if limit is None else limit
    assert got.shape == ref.shape == (n, LATENT)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_run_video_percep_matches_svtpu(tmp_path):
    """The percep branch: the tiny AutoencoderKL of
    ``tests/test_torch_perceptual.py``, a video at the SD input's size,
    deterministic codes bit for bit (7 frames, batches of 4)."""
    from test_torch_perceptual import (LATENT as P_LATENT, RBVAE, TINY,
                                       _encoders, _percep_rbvae)
    from svtpu_torch.models.convert import from_jax_params as rbvae_weights

    video = _write_video(tmp_path / "p.avi", 7,
                         hw=TINY["resize_wh"][::-1], seed=3)
    jae, tae = _encoders(stochastic=False)
    jcfg, params = _percep_rbvae()
    ref = _call(JaxPipeline(jcfg, params, percep=jae, batch=4,
                            noise=False).run_video, video)
    tcfg = rbvae_variant("percep", P_LATENT, **RBVAE)
    got = _call(VideoSymbolPipeline(tcfg, rbvae_weights(params, tcfg),
                                    percep=tae, batch=4, noise=False,
                                    device="cpu").run_video, video)
    assert got.shape == ref.shape == (7, P_LATENT)
    np.testing.assert_array_equal(got, ref)


def _batches(frames, batch):
    """``run_video``'s batches of decoded frames: the last padded with
    copies of its last frame."""
    out = []
    for i in range(0, len(frames), batch):
        b = frames[i:i + batch]
        out.append(np.concatenate([b, np.repeat(b[-1:], batch - len(b), 0)]))
    return out


def test_run_video_noisy_batches_are_seeded_by_their_ordinal(models,
                                                             video20):
    """Batch ``b`` (0, 1, 2) draws from ``batch_seed(seed, b)``, as
    ``svtpu`` folds the batch ordinal into its key; seeding by the first
    frame's index (0, 8, 16), as ``encode`` of a frame directory does, gives
    other codes."""
    *_, tcfg, sd = models
    pipe = VideoSymbolPipeline(tcfg, sd, batch=8, temperature=1.0,
                               noise_ratio=3.0, seed=5, device="cpu")
    got = _call(pipe.run_video, video20)
    batches = _batches(np.stack(list(iter_frames_cv2(video20))), 8)
    by_ordinal = np.concatenate([pipe.run_frames(b, batch_index=i)
                                 for i, b in enumerate(batches)])[:20]
    by_first_frame = np.concatenate([pipe.run_frames(b, batch_index=8 * i)
                                     for i, b in enumerate(batches)])[:20]
    assert got.shape == (20, LATENT) and 0 < got.mean() < 1
    np.testing.assert_array_equal(got, by_ordinal)
    assert not np.array_equal(got[8:], by_first_frame[8:])


def test_run_video_native_decoder_reads_batches(models, video20,
                                                with_native):
    """With the library built, ``run_video`` decodes natively: the codes of
    the frames ``read_batch`` returns, batch by batch; within a few levels
    of cv2's frames."""
    *_, tcfg, sd = models
    pipe = VideoSymbolPipeline(tcfg, sd, batch=8, noise=False,
                               device="cpu")
    got = _call(pipe.run_video, video20)
    with native.VideoReader(video20) as vr:
        frames = vr.read_batch(20)
    assert np.abs(frames.astype(int) - np.stack(list(
        iter_frames_cv2(video20))).astype(int)).mean() < 5
    want = np.concatenate([pipe.run_frames(b) for b in _batches(frames, 8)])
    np.testing.assert_array_equal(got, want[:20])


@pytest.mark.parametrize("built", [False, True], ids=["cv2", "native"])
def test_run_video_missing_file_raises(models, tmp_path, built,
                                       native_lib_dir, monkeypatch):
    """A decode error reaches the caller as ``OSError`` within the time
    limit (``svtpu``'s ``run_video`` blocks forever here), and the decode
    thread is gone when the call returns; with either decoder."""
    monkeypatch.setattr(native, "BUILD_DIR",
                        native_lib_dir if built else tmp_path / "none")
    assert native.available() == built
    *_, tcfg, sd = models
    pipe = VideoSymbolPipeline(tcfg, sd, device="cpu")
    with pytest.raises(OSError):
        _call(pipe.run_video, str(tmp_path / "missing.avi"))
    assert _decode_threads() == []


def test_run_video_encode_error_stops_the_decoder(models, video20,
                                                  monkeypatch):
    """An error in the encode of batch 1 reaches the caller, and the decode
    thread, blocked on a full queue, stops with the call."""
    *_, tcfg, sd = models
    pipe = VideoSymbolPipeline(tcfg, sd, batch=4, depth=1, noise=False,
                               device="cpu")
    real = pipe.run_frames

    def run_frames(frames, batch_index=0):
        if batch_index == 1:
            raise RuntimeError("encode failed")
        return real(frames, batch_index)

    monkeypatch.setattr(pipe, "run_frames", run_frames)
    with pytest.raises(RuntimeError, match="encode failed"):
        _call(pipe.run_video, video20)
    assert _decode_threads() == []


def test_run_video_limit_zero(models, video20):
    *_, tcfg, sd = models
    pipe = VideoSymbolPipeline(tcfg, sd, noise=False, device="cpu")
    assert _call(pipe.run_video, video20, limit=0).shape == (0, LATENT)


def test_auto_stays_on_pil_and_cv2_without_a_built_library(
        models, video20, tmp_path, native_lib_dir, without_native):
    """With the library built elsewhere (a test's directory), ``auto`` finds
    none where it looks: ``FrameStore`` decodes with PIL, ``run_video``
    with cv2 (the codes of cv2's frames), and nothing is built."""
    from PIL import Image

    assert native.library_path(native_lib_dir).exists()
    assert not native.available()
    for i in range(3):
        Image.fromarray(np.full((20, 30, 3), 60 * i, np.uint8)).save(
            tmp_path / f"{i:010d}.jpg")
    store = FrameStore(tmp_path, range(3), resolution=(10, 16))
    assert store.decoder == "pil"
    np.testing.assert_array_equal(
        store.array, FrameStore(tmp_path, range(3), resolution=(10, 16),
                                decoder="pil").array)
    *_, tcfg, sd = models
    pipe = VideoSymbolPipeline(tcfg, sd, batch=8, noise=False, device="cpu")
    auto = _call(pipe.run_video, video20)
    batches = _batches(np.stack(list(iter_frames_cv2(video20))), 8)
    want = np.concatenate([pipe.run_frames(b) for b in batches])[:20]
    np.testing.assert_array_equal(auto, want)
    assert not native.library_path().exists()


def test_frame_store_auto_takes_native_once_built(tmp_path, with_native):
    from PIL import Image

    for i in range(4):
        Image.fromarray(np.full((24, 32, 3), 50 * i, np.uint8)).save(
            tmp_path / f"{i:010d}.jpg")
    auto = FrameStore(tmp_path, range(4), resolution=(12, 16))
    pil = FrameStore(tmp_path, range(4), resolution=(12, 16),
                     decoder="pil")
    assert auto.decoder == "native"
    assert np.abs(auto.array.astype(int) - pil.array.astype(int)).max() <= 3


# --- the command line against svtpu.cli


def test_cli_extract_matches_svtpu(tiny_video, tmp_path, capsys):
    jcli.main(["extract", tiny_video, str(tmp_path / "ref"), "--every-n",
               "3"])
    cli.main(["extract", tiny_video, str(tmp_path / "ours"), "--every-n",
              "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == out[0].replace("ref", "ours") \
        == f"wrote 4 frames to {tmp_path / 'ours'}"
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


def test_cli_convert_matches_svtpu(tiny_video, tmp_path):
    jcli.main(["convert", tiny_video, str(tmp_path / "ref.avi")])
    cli.main(["convert", tiny_video, str(tmp_path / "ours.avi")])
    assert video_info(tmp_path / "ours.avi") == \
        video_info(tmp_path / "ref.avi")
    for a, b in zip(iter_frames_cv2(tmp_path / "ours.avi"),
                    iter_frames_cv2(tmp_path / "ref.avi"), strict=True):
        np.testing.assert_array_equal(a, b)


def test_cli_encode_video_matches_svtpu(models, video20, tmp_path):
    """``encode <video>`` of both CLIs on one set of weights, deterministic
    f32: the same codes and labels, bit for bit (batches of 8, limit 18)."""
    from svtpu.data.symbols import SymbolStore as JaxSymbolStore
    from svtpu.training.checkpoints import \
        BestCheckpointer as JaxCheckpointer
    from svtpu_torch.data.symbols import SymbolStore
    from svtpu_torch.training.checkpoints import BestCheckpointer

    jcfg = jax_variant("contrastive", 8, input_hw=(32, 32))
    tcfg = rbvae_variant("contrastive", 8, input_hw=(32, 32))
    params = seeded_jax_params(jcfg, seed=9)
    JaxCheckpointer(tmp_path / "jax_ckpt").save({"params": params},
                                                epoch=0, metric=0.0)
    BestCheckpointer(tmp_path / "port_ckpt").save(
        {"model": from_jax_params(params, tcfg), "optimizer": {}}, epoch=0,
        metric=0.0)
    args = [video20, "--latent-dim", "8", "--resolution", "32",
            "--deterministic", "--dtype", "float32", "--batch", "8",
            "--limit", "18", "--video", "v", "--flags", "6", "12",
            "--last-frame", "19"]
    _call(jcli.main, ["encode", *args, "--ckpt", str(tmp_path / "jax_ckpt"),
                      "--out", str(tmp_path / "ref.npz")])
    _call(cli.main, ["encode", *args, "--ckpt", str(tmp_path / "port_ckpt"),
                     "--out", str(tmp_path / "got.npz"), "--device", "cpu"])
    ref = JaxSymbolStore.load(tmp_path / "ref.npz")
    got = SymbolStore.load(tmp_path / "got.npz")
    assert got.codes.shape == (18, 8) and 0 < got.codes.mean() < 1
    np.testing.assert_array_equal(got.codes, ref.codes)
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_array_equal(got.frame_ids, ref.frame_ids)


def test_cli_encode_missing_video_exits_with_the_error(tmp_path):
    from svtpu_torch.models.rbvae import Seq2SeqBinaryVAE
    from svtpu_torch.training.checkpoints import BestCheckpointer

    sd = Seq2SeqBinaryVAE(rbvae_variant("contrastive", 8, input_hw=(32, 32)),
                          device="cpu").state_dict()
    BestCheckpointer(tmp_path / "ckpt").save({"model": sd, "optimizer": {}},
                                             epoch=0, metric=0.0)
    with pytest.raises(OSError, match="cannot open"):
        _call(cli.main, ["encode", str(tmp_path / "none.avi"), "--ckpt",
                         str(tmp_path / "ckpt"), "--latent-dim", "8",
                         "--resolution", "32", "--device", "cpu", "--out",
                         str(tmp_path / "s.npz")])
    assert not (tmp_path / "s.npz").exists()
