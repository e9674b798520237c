"""Host-side video and image writing.

Port of ``scmgan_tpu/analysis/video.py``.  The reference shells out to
ffmpeg/libx264 through ``imutil`` (reference README.md:20; e.g.
main.py:350,601-603); encoding stays on the host, out of every device path.
Backend order, as the JAX package's: imageio mp4 (when an ffmpeg plugin is
importable), the native uncompressed AVI (``scmgan_tpu_torch.native``, C
built with ``cc``), imageio GIF, per-frame PNGs (PIL), and last a
compressed ``.npz`` of the frames.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def to_uint8(frame: np.ndarray) -> np.ndarray:
    """float [0,1] (H, W, C) or (H, W) -> uint8 RGB."""
    frame = np.asarray(frame)
    if frame.ndim == 2:
        frame = frame[:, :, None]
    if frame.shape[-1] == 1:
        frame = np.repeat(frame, 3, axis=-1)
    if frame.shape[-1] > 3:
        frame = frame[:, :, :3]
    frame = np.clip(frame, 0.0, 1.0)
    return (frame * 255).astype(np.uint8)


def resize_nearest(frame: np.ndarray, size: tuple) -> np.ndarray:
    """Nearest-neighbour resize without external dependencies."""
    h, w = frame.shape[:2]
    th, tw = size
    rows = (np.arange(th) * h // th).clip(0, h - 1)
    cols = (np.arange(tw) * w // tw).clip(0, w - 1)
    return frame[rows][:, cols]


class Video:
    """Minimal drop-in for imutil.Video: ``write_frame`` + ``finish``."""

    def __init__(self, filename: str, framerate: int = 10):
        self.filename = filename
        self.framerate = framerate
        self.frames = []

    def write_frame(self, frame, resize_to: Optional[tuple] = None,
                    caption: str = "", **_):
        img = to_uint8(frame)
        if resize_to is not None:
            img = resize_nearest(img, resize_to)
        self.frames.append(img)

    def finish(self) -> str:
        """Encode and write; returns the path actually written."""
        if not self.frames:
            return self.filename
        frames = self.frames
        base, _ = os.path.splitext(self.filename)
        try:
            import imageio
        except ImportError:
            imageio = None
        # 1. mp4 via imageio + ffmpeg
        if imageio is not None:
            try:
                with imageio.get_writer(base + ".mp4", fps=self.framerate) as w:
                    for f in frames:
                        w.append_data(f)
                return base + ".mp4"
            except Exception:  # noqa: BLE001 - no ffmpeg plugin: next backend
                pass
        # 2. the native AVI writer
        try:
            from scmgan_tpu_torch.native import aviwriter

            path = base + ".avi"
            aviwriter.write_avi(path, np.stack(frames), self.framerate)
            return path
        except Exception:  # noqa: BLE001 - no C compiler or write error: next backend
            pass
        # 3. GIF
        if imageio is not None:
            try:
                imageio.mimsave(base + ".gif", frames, duration=1.0 / self.framerate)
                return base + ".gif"
            except Exception:  # noqa: BLE001 - no GIF plugin: next backend
                pass
        # 4. PNG frames, else an .npz of them
        try:
            from PIL import Image
        except ImportError:
            np.savez_compressed(base + "_frames.npz", frames=np.stack(frames))
            return base + "_frames.npz"
        os.makedirs(base + "_frames", exist_ok=True)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(base + "_frames", f"{i:05d}.png"))
        return base + "_frames"


def save_image(pixels, filename: str, resize_to: Optional[tuple] = None):
    img = to_uint8(np.asarray(pixels, dtype=np.float64)
                   / max(float(np.max(pixels)), 1e-8))
    if resize_to is not None:
        img = resize_nearest(img, resize_to)
    from PIL import Image

    Image.fromarray(img).save(filename)
    return filename
