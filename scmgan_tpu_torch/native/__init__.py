"""Native (C) host components, built with ``cc`` and loaded with ctypes.

Port of ``scmgan_tpu/native/__init__.py`` with the package's own copies of
the two C sources under ``src/``:

  * avi_writer — uncompressed-AVI video encoder (the native stand-in for
    the reference's ffmpeg/libx264 dependency, reference README.md:20);
  * stitcher   — replay-buffer trajectory clip stitching, the host
    data-loader hot loop (reference envs/minipacman.py:139-164).

Build model: ``cc -O3 -shared -fPIC`` at first use, never at import, into
``build/scmgan_tpu_torch/`` under a name keyed by a hash of the sources and
flags, so an edited source rebuilds and a stale library is never loaded.
The build writes a temporary name and renames it into place.  The library's
name differs from the JAX package's ``libscmgan_native.so``, so both can be
loaded in one process; nothing here writes into ``scmgan_tpu/``.  A build
that fails raises with the compiler's output: there is no fall-back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "scmgan_tpu_torch"
SOURCES = ("avi_writer.c", "stitcher.c")
CFLAGS = ("-O3", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)


def _cc() -> str:
    found = shutil.which("cc")
    if found is None:
        raise RuntimeError("no C compiler: `cc` is not on PATH")
    return found


def compiler() -> str:
    """The first line of ``cc --version``."""
    out = subprocess.run([_cc(), "--version"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.splitlines()[0]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libscmgan_torch_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the library unless it is already built.
    Raises with the compiler's stderr if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([_cc(), *CFLAGS, "-o", str(tmp),
                               *(str(SRC / name) for name in SOURCES)],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"cc failed with code {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.write_avi.restype = ctypes.c_int
            lib.write_avi.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
            lib.stitch.restype = None
            lib.stitch.argtypes = [
                _F, _F, _I, ctypes.POINTER(ctypes.c_long), _I,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                _F, _F, _I, ctypes.POINTER(ctypes.c_ubyte),
            ]
            _lib = lib
    return _lib


class _AviWriterModule:
    """The namespace ``analysis/video.py`` writes through."""

    @staticmethod
    def write_avi(path: str, frames: np.ndarray, fps: int = 10):
        """frames: (N, H, W, 3) uint8 RGB."""
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"write_avi expects (N, H, W, 3) RGB frames, got "
                             f"{frames.shape}")
        n, h, w, _ = frames.shape
        rc = library().write_avi(str(path).encode(),
                                 frames.ctypes.data_as(ctypes.c_char_p),
                                 n, h, w, int(fps))
        if rc != 0:
            raise OSError(f"write_avi failed with code {rc}")
        return path


aviwriter = _AviWriterModule()


def stitch_batch(frames: np.ndarray, rewards: np.ndarray,
                 actions: np.ndarray, ep_offsets: np.ndarray,
                 ep_lengths: np.ndarray, batch: int, timesteps: int,
                 random_start: bool = True, seed: int = 1):
    """C clip stitching over contiguous episode arenas.

    frames: (total_steps, *frame_shape) f32; rewards: (total_steps, R) f32;
    actions: (total_steps,) i32; ep_offsets/ep_lengths: per-episode step
    offset/length into the arenas.
    Returns (frames (B,T,...), rewards (B,T,R), dones (B,T) bool,
    actions (B,T)).
    """
    if len(ep_lengths) == 0:
        raise ValueError("stitch_batch needs at least one episode")
    frames = np.ascontiguousarray(frames, np.float32)
    rewards = np.ascontiguousarray(rewards, np.float32)
    actions = np.ascontiguousarray(actions, np.int32)
    ep_offsets = np.ascontiguousarray(ep_offsets, np.int64)
    ep_lengths = np.ascontiguousarray(ep_lengths, np.int32)
    rows = len(frames)
    if (rewards.ndim != 2 or len(rewards) != rows or actions.shape != (rows,)
            or ep_offsets.shape != ep_lengths.shape):
        raise ValueError("stitch_batch: arenas or episode tables disagree in shape")
    if (ep_offsets < 0).any() or (ep_offsets + ep_lengths > rows).any():
        raise ValueError("stitch_batch: an episode lies outside the arenas")
    frame_shape = frames.shape[1:]
    frame_elems = int(np.prod(frame_shape))
    reward_elems = rewards.shape[1]

    out_f = np.empty((batch, timesteps, *frame_shape), np.float32)
    out_r = np.empty((batch, timesteps, reward_elems), np.float32)
    out_a = np.empty((batch, timesteps), np.int32)
    out_d = np.empty((batch, timesteps), np.uint8)

    def fp(a):
        return a.ctypes.data_as(_F)

    def ip(a):
        return a.ctypes.data_as(_I)

    library().stitch(
        fp(frames), fp(rewards), ip(actions),
        ep_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ip(ep_lengths), len(ep_lengths), frame_elems, reward_elems,
        batch, timesteps, int(random_start), seed,
        fp(out_f), fp(out_r), ip(out_a),
        out_d.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out_f, out_r, out_d.astype(bool), out_a
