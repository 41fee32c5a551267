"""ctypes bindings for the native C++ video decode and preprocess library,
the port's copy of ``valley_tpu/native/__init__.py`` with the same
functions and signatures (`video_info`, `decode_preprocess`,
`decode_preprocess_raw`) over its own copy of ``video_decode.cc``.

The library is built at first use with ``g++`` against libav
(``-lavformat -lavcodec -lavutil -lswscale``) into
``valley_tpu_torch/build/`` under a name keyed by a hash of the source and
the flags.  The build writes a temporary file and renames it into place
under a file lock, so processes that build at once (test workers) wait for
one another and never load a short file.  Where the compiler or the libav
libraries are missing, every call raises ImportError with the reason, and
`data.video.load_video` decodes with OpenCV instead, as the JAX package
does.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "video_decode.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def library_path() -> Path:
    """Where the source builds to, keyed by the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libvalley_video-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The built library, compiled first where it is not there: under an
    exclusive lock on a file beside it, into a temporary name renamed
    into place.  Raises ImportError with the compiler's output where the
    build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libvalley_video.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():            # another process built it meanwhile
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                 str(SOURCE), *LIBS], capture_output=True, text=True,
                timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            os.unlink(tmp)
            raise ImportError(f"native video decoder: the build failed: "
                              f"{e}") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise ImportError("native video decoder: the build failed "
                              f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.cache
def _load() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(build()))
    except OSError as e:
        raise ImportError(f"native video decoder: cannot load: {e}") from e
    c = ctypes
    lib.valley_decode_video.restype = c.c_int
    lib.valley_decode_video.argtypes = [
        c.c_char_p, c.c_int, c.c_int, c.c_double, c.c_int, c.c_int,
        c.POINTER(c.c_float), c.POINTER(c.c_float), c.POINTER(c.c_float),
        c.POINTER(c.c_int), c.c_int]
    lib.valley_decode_video_raw.restype = c.c_int
    lib.valley_decode_video_raw.argtypes = [
        c.c_char_p, c.c_int, c.c_int, c.c_double, c.c_int, c.c_int,
        c.POINTER(c.c_uint8), c.POINTER(c.c_int), c.c_int]
    lib.valley_video_info.restype = c.c_int
    lib.valley_video_info.argtypes = [
        c.c_char_p, c.POINTER(c.c_long), c.POINTER(c.c_double)]
    return lib


def _planes(out: np.ndarray, frames: int, crop: int) -> np.ndarray:
    """The (3, frames, crop, crop) result in the buffer the library wrote:
    its channel planes lie packed at the frames it decoded, which in fps
    mode are fewer than the buffer holds (the JAX binding slices a
    (3, max_frames, ...) view instead, and so returns unwritten memory
    for channels 1 and 2 there)."""
    return out[:3 * frames * crop * crop].reshape(3, frames, crop, crop)


def video_info(path: str) -> Tuple[int, float]:
    """(frame count, frames per second) of a video file."""
    lib = _load()
    n = ctypes.c_long()
    fps = ctypes.c_double()
    rc = lib.valley_video_info(path.encode(), ctypes.byref(n),
                               ctypes.byref(fps))
    if rc != 0:
        raise IOError(f"valley_video_info({path}) failed: {rc}")
    return n.value, fps.value


def decode_preprocess(path: str, frame_mode: str = "fixed",
                      num_frames: int = 8, fps_number: float = 0.5,
                      scale_size: int = 256, crop_size: int = 224,
                      mean=CLIP_MEAN, std=CLIP_STD,
                      max_frames: int = 64) -> np.ndarray:
    """Decode, sample, resize, crop and CLIP-normalize in native code:
    (3, T, crop, crop) fp32, `data.video.load_video`'s result in one
    call."""
    lib = _load()
    mode = 0 if frame_mode == "fixed" else 1
    cap = num_frames if mode == 0 else max_frames
    out = np.empty(3 * cap * crop_size * crop_size, np.float32)
    mean_a = (ctypes.c_float * 3)(*mean)
    std_a = (ctypes.c_float * 3)(*std)
    nf = ctypes.c_int()
    rc = lib.valley_decode_video(
        path.encode(), mode, num_frames, fps_number, scale_size, crop_size,
        mean_a, std_a,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(nf), cap)
    if rc != 0:
        raise IOError(f"valley_decode_video({path}) failed: {rc}")
    return _planes(out, nf.value, crop_size)


def decode_preprocess_raw(path: str, frame_mode: str = "fixed",
                          num_frames: int = 8, fps_number: float = 0.5,
                          scale_size: int = 256, crop_size: int = 224,
                          max_frames: int = 64) -> np.ndarray:
    """`decode_preprocess` without the normalization: (3, T, crop, crop)
    uint8, the raw pixels that `models.valley.encode_images` normalizes on
    the device."""
    lib = _load()
    mode = 0 if frame_mode == "fixed" else 1
    cap = num_frames if mode == 0 else max_frames
    out = np.empty(3 * cap * crop_size * crop_size, np.uint8)
    nf = ctypes.c_int()
    rc = lib.valley_decode_video_raw(
        path.encode(), mode, num_frames, fps_number, scale_size, crop_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(nf), cap)
    if rc != 0:
        raise IOError(f"valley_decode_video_raw({path}) failed: {rc}")
    return _planes(out, nf.value, crop_size)
