"""Video → frame directory, and video conversion: the port's counterpart
of ``svtpu/data/frames.py``.

Backends that iterate a video's RGB frames as ``[H, W, 3]`` uint8:

  * ``cv2``    — OpenCV's ``VideoCapture``
  * ``native`` — the libav reader of ``svtpu_torch.data.native`` (built on
                 first use)
  * ``pyav`` / ``decord`` — where those packages are installed, else
                 ``ImportError``

Frames are written as ``%010d.jpg`` (``FRAME_PATTERN``), the naming every
frame directory reader keys on. ``download_sd_weights`` fetches the SD
checkpoint from the Hugging Face hub where ``huggingface_hub`` imports.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np

FRAME_PATTERN = "{:010d}.jpg"


def iter_frames_cv2(video_path: str) -> Iterator[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def iter_frames_pyav(video_path: str) -> Iterator[np.ndarray]:
    try:
        import av
    except ImportError as e:
        raise ImportError("pyav backend requested but 'av' is not "
                          "installed; use backend='cv2' or 'native'") from e
    with av.open(str(video_path)) as container:
        for frame in container.decode(video=0):
            yield frame.to_ndarray(format="rgb24")


def iter_frames_decord(video_path: str) -> Iterator[np.ndarray]:
    try:
        import decord
    except ImportError as e:
        raise ImportError("decord backend requested but not installed; "
                          "use backend='cv2' or 'native'") from e
    vr = decord.VideoReader(str(video_path))
    for i in range(len(vr)):
        yield vr[i].asnumpy()


def iter_frames_native(video_path: str) -> Iterator[np.ndarray]:
    from svtpu_torch.data.native import VideoReader

    with VideoReader(str(video_path)) as vr:
        yield from vr


BACKENDS = {
    "cv2": iter_frames_cv2,
    "pyav": iter_frames_pyav,
    "decord": iter_frames_decord,
    "native": iter_frames_native,
}


def extract_frames(video_path: str | Path, out_dir: str | Path,
                   backend: str = "cv2", every_n: int = 1,
                   limit: Optional[int] = None,
                   quality: int = 95) -> int:
    """Decode ``video_path`` and write every ``every_n``-th frame to
    ``out_dir`` as an RGB JPEG (PIL, ``quality``), named by its index in
    the video; stop after ``limit`` written. Returns the number written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        it = BACKENDS[backend](str(video_path))
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"choose from {sorted(BACKENDS)}")
    from PIL import Image

    written = 0
    for i, frame in enumerate(it):
        if i % every_n:
            continue
        Image.fromarray(frame).save(out_dir / FRAME_PATTERN.format(i),
                                    quality=quality)
        written += 1
        if limit is not None and written >= limit:
            break
    return written


def video_info(video_path: str | Path) -> dict:
    """Frame count, frame rate and size as the container reports them."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    try:
        return {
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            "fps": float(cap.get(cv2.CAP_PROP_FPS)),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        }
    finally:
        cap.release()


def convert_video(src: str | Path, dst: str | Path,
                  fourcc: str = "MJPG") -> None:
    """Re-encode ``src`` into ``dst`` with OpenCV's writer (codec
    ``fourcc``), at the source's frame rate (30 where it reports none) and
    size."""
    import cv2

    cap = cv2.VideoCapture(str(src))
    if not cap.isOpened():
        raise IOError(f"cannot open video: {src}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(str(dst), cv2.VideoWriter_fourcc(*fourcc),
                             fps, (w, h))
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            writer.write(frame)
    finally:
        cap.release()
        writer.release()


def download_sd_weights(out_dir: str | Path,
                        repo_id: str = "CompVis/stable-diffusion-v-1-4-original",
                        filename: str = "sd-v1-4.ckpt") -> str:
    """HF-hub download of the SD checkpoint (reference
    ``scripts/download_weights.py:1-3``) into ``out_dir``; returns its path.
    Raises ``ImportError`` naming the manual route where
    ``huggingface_hub`` is not installed."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise ImportError(
            "huggingface_hub is not installed; download sd-v1-4.ckpt "
            "manually and pass its path to "
            "svtpu_torch.perceptual.convert.load_torch_checkpoint") from e
    return hf_hub_download(repo_id=repo_id, filename=filename,
                           local_dir=str(out_dir))
