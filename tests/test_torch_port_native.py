"""The port's native C components (scmgan_tpu_torch.native) against
scmgan_tpu.native on the CPU: the AVI writer byte for byte, the clip
stitcher bit for bit, and the port's own build (its library under
build/scmgan_tpu_torch/, nothing written into the JAX package, a failed
build raising with the compiler's output)."""

import os
import subprocess

import numpy as np
import pytest

from scmgan_tpu import native as jnative
from scmgan_tpu.analysis import video as jvideo
from scmgan_tpu_torch import native as tnative
from scmgan_tpu_torch.analysis import video as tvideo


def ensure_jax_native():
    """Build the JAX package's native library where its loader expects it,
    to a temporary name renamed into place.  Its own loader compiles in
    place, so a test process could load a half-written library while
    another test process compiles it; once this has run, it finds the
    library current and builds nothing."""
    sources = [os.path.join(jnative._SRC, f) for f in tnative.SOURCES]
    lib = jnative._LIB_PATH
    if os.path.exists(lib) and os.path.getmtime(lib) >= max(map(os.path.getmtime, sources)):
        return
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o", tmp, *sources], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


def _frames(seed, n, h, w):
    return (np.random.default_rng(seed).random((n, h, w, 3)) * 255).astype(np.uint8)


# (n, h, w, fps): widths 17 and 13 leave 51 and 39 bytes a row, padded to
# 52 and 40 (4-byte rows); 1x1 and a single frame are the edge cases.
AVI_CASES = [(4, 16, 24, 5), (2, 8, 17, 5), (3, 5, 13, 10), (1, 1, 1, 1), (6, 64, 64, 10)]


@pytest.mark.parametrize("n,h,w,fps", AVI_CASES)
def test_write_avi_is_byte_equal_to_jax(tmp_path, n, h, w, fps):
    frames = _frames(n * h + w, n, h, w)
    want = jnative.aviwriter.write_avi(str(tmp_path / "jax.avi"), frames, fps=fps)
    got = tnative.aviwriter.write_avi(str(tmp_path / "port.avi"), frames, fps=fps)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert int.from_bytes(data[4:8], "little") == len(data) - 8
    row = (w * 3 + 3) & ~3
    assert len(data) > n * row * h


def test_write_avi_rejects_non_rgb(tmp_path):
    with pytest.raises(ValueError, match="RGB"):
        tnative.aviwriter.write_avi(str(tmp_path / "x.avi"), np.zeros((2, 4, 4), np.uint8))


def test_video_finish_writes_the_same_avi(tmp_path, monkeypatch):
    """Without an ffmpeg plugin both packages' videos land as the native
    AVI, byte-equal (mp4 is forced to fail so the test is the same whatever
    imageio plugins exist)."""
    import imageio

    def no_mp4(*a, **k):
        raise ValueError("no ffmpeg plugin")

    monkeypatch.setattr(imageio, "get_writer", no_mp4)
    frames = np.random.default_rng(0).random((5, 9, 11, 3))
    paths = []
    for mod, name in ((jvideo, "jax"), (tvideo, "port")):
        v = mod.Video(str(tmp_path / f"{name}.mp4"), framerate=7)
        for f in frames:
            v.write_frame(f, resize_to=(18, 22))
        paths.append(v.finish())
    assert [os.path.splitext(p)[1] for p in paths] == [".avi", ".avi"]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def _arenas(seed, lengths, frame_shape=(2, 3), reward_dim=2, gap=3):
    """Episodes laid out with ``gap`` unused rows between them, as the slot
    arena leaves them."""
    rng = np.random.default_rng(seed)
    offsets = np.cumsum([0] + [n + gap for n in lengths[:-1]]).astype(np.int64)
    rows = int(offsets[-1] + lengths[-1] + gap)
    frames = rng.random((rows,) + frame_shape).astype(np.float32)
    rewards = rng.random((rows, reward_dim)).astype(np.float32)
    actions = rng.integers(0, 7, rows).astype(np.int32)
    return frames, rewards, actions, offsets, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("random_start", [True, False], ids=["random_start", "start0"])
@pytest.mark.parametrize("seed,lengths,batch,timesteps", [
    (1, [12, 9], 8, 10),
    (2, [30], 4, 8),
    (3, [5, 1, 4, 150, 2], 6, 25),   # a 1-step and a 2-step episode: skipped or short
    (0, [7, 8], 3, 40),              # seed 0: the stitcher's default state
])
def test_stitch_batch_is_bit_equal_to_jax(seed, lengths, batch, timesteps, random_start):
    arenas = _arenas(seed, lengths)
    want = jnative.stitch_batch(*arenas, batch, timesteps, random_start=random_start,
                                seed=seed)
    got = tnative.stitch_batch(*arenas, batch, timesteps, random_start=random_start,
                               seed=seed)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    frames, _, dones, actions = got
    assert frames.shape == (batch, timesteps, 2, 3)
    assert dones[:, -1].all()          # every row ends a clip


def test_stitch_batch_validates_its_tables():
    frames, rewards, actions, offsets, lengths = _arenas(0, [6, 6])
    with pytest.raises(ValueError, match="at least one episode"):
        tnative.stitch_batch(frames, rewards, actions, offsets[:0], lengths[:0], 2, 4)
    with pytest.raises(ValueError, match="outside the arenas"):
        tnative.stitch_batch(frames, rewards, actions, offsets + 100, lengths, 2, 4)
    with pytest.raises(ValueError, match="disagree"):
        tnative.stitch_batch(frames, rewards[:-1], actions, offsets, lengths, 2, 4)


def test_library_lives_in_the_port_build_dir():
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "scmgan_tpu_torch")
    assert path.name.startswith("libscmgan_torch_native_") and path.suffix == ".so"
    assert tnative.library()._name == str(path)
    assert path.exists()


def test_build_writes_only_into_the_port_build_dir(tmp_path, monkeypatch):
    """The port compiles its own sources and writes its library only under
    its build directory, never into the JAX package."""
    calls = []
    run = subprocess.run

    def recording(argv, **kw):
        calls.append(list(argv))
        return run(argv, **kw)

    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative.subprocess, "run", recording)
    out = tnative.build()
    assert out.parent == tmp_path / "build" and out.exists()
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]  # no temporary left
    (argv,) = calls
    target = argv[argv.index("-o") + 1]
    assert os.path.dirname(target) == str(tmp_path / "build")
    assert [a for a in argv if a.endswith(".c")] == [str(tnative.SRC / n) for n in tnative.SOURCES]
    jax_dir = os.path.dirname(os.path.abspath(jnative.__file__))
    assert not any(a.startswith(jax_dir) for a in argv)
    assert tnative.build() == out and len(calls) == 1   # built once, then found


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in tnative.SOURCES:
        (src / name).write_text("this is not C;\n")
    monkeypatch.setattr(tnative, "SRC", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="cc failed") as err:
        tnative.build()
    assert "error" in str(err.value)
    assert list((tmp_path / "build").iterdir()) == []


def test_sources_match_the_jax_copies_but_for_comments():
    """The port keeps its own copies; their code is the JAX package's."""
    def code(path):
        text = open(path).read()
        return text[text.index("#include"):]

    for name in tnative.SOURCES:
        assert code(tnative.SRC / name) == code(
            os.path.join(os.path.dirname(jnative.__file__), "src", name))
