"""The native video decoder of the PyTorch port (`valley_tpu_torch.native`,
its own copy of ``video_decode.cc`` built with g++ against libav) and the
decoder chain of its `load_video`, against the JAX package's native
decoder (``valley_tpu/native``) and ``load_video``
(``valley_tpu/data/video.py:171-188``).

The video is synthetic: 30 frames of 80x60 written with
``cv2.VideoWriter`` (mp4v) from a seed, smooth gradients plus noise.
Bars: bit for bit.  The two packages' native decoders are the same source
built with the same flags; their OpenCV paths run the same numpy
transforms.  The port's build takes a lock and renames a temporary file
into place, so six processes building at once into one fresh directory
all load a whole library.  The file takes about 15 s on its worker alone
(the build's share of it is some 5 s).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from valley_tpu_torch import native
from valley_tpu_torch.data import video

ROOT = Path(__file__).resolve().parents[1]
# (frame mode, frames, scale, crop): fixed and fps sampling, the serving
# 224 crop and a small one
SETTINGS = [("fixed", 8, 256, 224), ("fixed", 3, 32, 28), ("fps", 4, 64, 56)]
IDS = ["fixed8_224", "fixed3_28", "fps_56"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    path = tmp_path_factory.mktemp("native_video") / "clip.mp4"
    rng = np.random.default_rng(51)
    yy, xx = np.mgrid[0:60, 0:80]
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (80, 60))
    for t in range(30):
        base = np.stack([(xx * 3 + t * 5) % 256, (yy * 4 + t * 3) % 256,
                         (xx + yy + t * 7) % 256], axis=-1)
        noise = rng.integers(-8, 9, base.shape)
        w.write(np.clip(base + noise, 0, 255).astype(np.uint8))
    w.release()
    return str(path)


@pytest.fixture(scope="module")
def jnative():
    """The JAX package's native decoder (built by its own make); skipped
    where it cannot be built, as tests/test_native.py skips."""
    mod = pytest.importorskip("valley_tpu.native")
    try:
        mod._load()
    except ImportError as e:
        pytest.skip(f"the JAX package's native decoder: {e}")
    return mod


def test_video_info_equals_jax(clip, jnative):
    assert native.video_info(clip) == jnative.video_info(clip)
    assert native.video_info(clip)[0] == 30


@pytest.mark.parametrize("setting", SETTINGS, ids=IDS)
def test_decode_preprocess_equals_jax_bit_for_bit(clip, jnative, setting):
    """`decode_preprocess` (CLIP-normalised fp32) and
    `decode_preprocess_raw` (uint8) equal the JAX package's, bit for
    bit, in fixed mode; in fps mode they equal what JAX's library wrote,
    its channel planes read packed at the frames decoded, and JAX's
    binding's channel 0 (its channels 1 and 2 there are a view of
    unwritten memory: `native._planes`)."""
    mode, n, scale, crop = setting
    for raw in (False, True):
        name = "decode_preprocess_raw" if raw else "decode_preprocess"
        got = getattr(native, name)(clip, mode, n, 0.5, scale, crop)
        want = getattr(jnative, name)(clip, mode, n, 0.5, scale, crop)
        assert got.dtype == want.dtype == (np.uint8 if raw else np.float32)
        assert got.shape == want.shape and got.shape[2:] == (crop, crop)
        if mode == "fixed":
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
        np.testing.assert_array_equal(
            got, _jax_library_fps(jnative, clip, raw, scale, crop),
            err_msg=name)


def _jax_library_fps(jnative, clip, raw, scale, crop, cap=64):
    """The JAX package's library called in fps mode on a buffer of its
    own, read packed at the frames it decoded."""
    import ctypes

    lib = jnative._load()
    out = np.zeros(3 * cap * crop * crop, np.uint8 if raw else np.float32)
    nf = ctypes.c_int()
    if raw:
        rc = lib.valley_decode_video_raw(
            clip.encode(), 1, 0, 0.5, scale, crop,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(nf), cap)
    else:
        rc = lib.valley_decode_video(
            clip.encode(), 1, 0, 0.5, scale, crop,
            (ctypes.c_float * 3)(*native.CLIP_MEAN),
            (ctypes.c_float * 3)(*native.CLIP_STD),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(nf), cap)
    assert rc == 0
    n = nf.value
    return out[:3 * n * crop * crop].reshape(3, n, crop, crop)


@pytest.mark.parametrize("disable", [False, True],
                         ids=["native", "opencv"])
@pytest.mark.parametrize("raw", [False, True], ids=["fp32", "uint8"])
def test_load_video_follows_jax_chain(clip, jnative, monkeypatch, disable,
                                      raw):
    """`load_video` equals JAX's ``load_video`` bit for bit, with the
    native decoders (the default) and with ``VALLEY_DISABLE_NATIVE``
    (both packages' OpenCV paths); `last_decoder` names the path taken."""
    from valley_tpu.data import video as jvideo

    if disable:
        monkeypatch.setenv("VALLEY_DISABLE_NATIVE", "1")
    kw = dict(fixed_frame_number=4, crop_size=56, scale_size=64,
              raw_pixels=raw)
    got = video.load_video(clip, **kw)
    assert video.last_decoder == ("opencv" if disable else "native")
    want = jvideo.load_video(clip, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape == (
        3, 4, 56, 56)
    np.testing.assert_array_equal(got, want)


def test_load_video_falls_back_to_opencv(clip, monkeypatch):
    """Where the native decoder does not build or load (ImportError), and
    in adaptive mode, `load_video` decodes with OpenCV: the frames of
    ``VALLEY_DISABLE_NATIVE``."""
    kw = dict(fixed_frame_number=4, crop_size=56, scale_size=64)
    monkeypatch.setenv("VALLEY_DISABLE_NATIVE", "1")
    opencv = video.load_video(clip, **kw)
    monkeypatch.delenv("VALLEY_DISABLE_NATIVE")
    native_out = video.load_video(clip, **kw)
    assert video.last_decoder == "native"
    assert not np.array_equal(native_out, opencv)

    def missing():
        raise ImportError("no libav here")

    monkeypatch.setattr(native, "_load", missing)
    np.testing.assert_array_equal(video.load_video(clip, **kw), opencv)
    assert video.last_decoder == "opencv"
    video.load_video(clip, frame_mode="adaptive", **kw)
    assert video.last_decoder == "opencv"


def test_concurrent_builds_leave_a_whole_library(clip, tmp_path):
    """Six processes build the library at once into one fresh directory:
    each loads it and reads the video (no short file), and one library
    stands in the directory, beside its lock, no temporary left."""
    code = ("import sys\nfrom pathlib import Path\n"
            "from valley_tpu_torch import native\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "print(native.video_info(sys.argv[2])[0])\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path),
                               clip], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert [o.split()[-1] for o in outs] == ["30"] * 6
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["libvalley_video.lock", native.library_path().name])
