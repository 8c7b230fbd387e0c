"""ctypes bindings for the port's native host runtime, built at first use.

Counterpart of `streamvln_tpu/native/__init__.py`, with the port's own
copies of its two C++ sources: `dataloader.cpp` (libjpeg decode, a
PIL-exact threaded bicubic resize, the fused normalize) and `video.cpp`
(libav demux and decode). Each is compiled with the host's `g++` at first
use into `streamvln_tpu_torch/_build/` (listed in .gitignore), under a
file name that carries a hash of its source and flags, so an edited
source is rebuilt and nothing is written beside the sources.

`available()` and `video_available()` gate the callers
(data/vln_dataset.py, eval/env_workers.py, data/cotrain_datasets.py):
where a library does not build (no `jpeglib.h`, no ffmpeg headers) each
caller takes its PIL or cv2 path, as the reference's do, and
`build_error()` / `video_build_error()` say why. These are host
functions: no device or kernel stands behind them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SRC = os.path.join(_HERE, "dataloader.cpp")
_VIDEO_SRC = os.path.join(_HERE, "video.cpp")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
LIBS = ("-ljpeg",)
VIDEO_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")


class _Native:
    """One shared library: built once per process (or found built), loaded,
    its functions declared; or the reason it is unavailable."""

    def __init__(self, src: str, name: str, libs, declare):
        self.src, self.name, self.libs, self.declare = src, name, libs, \
            declare
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None
        self.lock = threading.Lock()

    def path(self) -> str:
        h = hashlib.sha256()
        with open(self.src, "rb") as f:
            h.update(f.read())
        h.update(" ".join(FLAGS + self.libs).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def _build(self, path: str) -> Optional[str]:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = ["g++", *FLAGS, self.src, "-o", tmp, *self.libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return str(e)
        if proc.returncode != 0:
            return proc.stderr[-2000:]
        os.replace(tmp, path)
        return None

    def load(self) -> Optional[ctypes.CDLL]:
        with self.lock:
            if self.lib is not None or self.error is not None:
                return self.lib
            path = self.path()
            if not os.path.exists(path):
                self.error = self._build(path)
                if self.error is not None:
                    return None
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                self.error = str(e)
                return None
            self.declare(lib)
            self.lib = lib
            return lib

    def require(self) -> ctypes.CDLL:
        lib = self.load()
        if lib is None:
            raise RuntimeError(f"native {self.name} unavailable: "
                               f"{self.error}")
        return lib


def _declare(lib) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.svt_preprocess_batch.restype = ci
    lib.svt_preprocess_batch.argtypes = [vp, ci, ci, ci, vp, ci, cf, cf]
    lib.svt_load_preprocess_jpegs.restype = ci
    lib.svt_load_preprocess_jpegs.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ci, vp, ci, cf, cf]
    lib.svt_jpeg_dims.restype = ci
    lib.svt_jpeg_dims.argtypes = [vp, ctypes.c_size_t,
                                  ctypes.POINTER(ci), ctypes.POINTER(ci)]
    lib.svt_decode_jpeg.restype = ci
    lib.svt_decode_jpeg.argtypes = [vp, ctypes.c_size_t, vp, ci, ci]
    lib.svt_resize_batch_u8.restype = ci
    lib.svt_resize_batch_u8.argtypes = [vp, ci, ci, ci, vp, ci]


def _declare_video(lib) -> None:
    ci = ctypes.c_int
    lib.svt_video_info.restype = ci
    lib.svt_video_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ci), ctypes.POINTER(ci),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    lib.svt_video_read_frames.restype = ci
    lib.svt_video_read_frames.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ci,
        ctypes.c_void_p, ci, ci]


_jpeg = _Native(_SRC, "streamvln_native", LIBS, _declare)
_video = _Native(_VIDEO_SRC, "streamvln_video", VIDEO_LIBS, _declare_video)


def available() -> bool:
    return _jpeg.load() is not None


def build_error() -> Optional[str]:
    _jpeg.load()
    return _jpeg.error


def _frames(frames_u8: np.ndarray) -> np.ndarray:
    frames_u8 = np.ascontiguousarray(frames_u8, np.uint8)
    if frames_u8.ndim != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"frames must be [N, H, W, 3] uint8, got "
                         f"{frames_u8.shape}")
    return frames_u8


def preprocess_batch(frames_u8: np.ndarray, size: int = 384,
                     mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """[N, H, W, 3] uint8 -> [N, size, size, 3] float32 (threaded C++)."""
    lib = _jpeg.require()
    frames_u8 = _frames(frames_u8)
    n, h, w, _ = frames_u8.shape
    out = np.empty((n, size, size, 3), np.float32)
    rc = lib.svt_preprocess_batch(
        frames_u8.ctypes.data_as(ctypes.c_void_p), n, h, w,
        out.ctypes.data_as(ctypes.c_void_p), size, mean, std)
    if rc != 0:
        raise RuntimeError(f"preprocess_batch failed on {rc} frames")
    return out


def resize_batch_u8(frames_u8: np.ndarray, size: int = 384) -> np.ndarray:
    """[N, H, W, 3] uint8 -> [N, size, size, 3] uint8: PIL's bicubic to
    within one 8-bit step (the fixed-point rounding of a few values), on a
    thread pool."""
    lib = _jpeg.require()
    frames_u8 = _frames(frames_u8)
    n, h, w, _ = frames_u8.shape
    out = np.empty((n, size, size, 3), np.uint8)
    rc = lib.svt_resize_batch_u8(
        frames_u8.ctypes.data_as(ctypes.c_void_p), n, h, w,
        out.ctypes.data_as(ctypes.c_void_p), size)
    if rc != 0:
        raise RuntimeError("resize_batch_u8 failed")
    return out


def load_preprocess_jpegs(paths: List[str], size: int = 384,
                          mean: float = 0.5,
                          std: float = 0.5) -> np.ndarray:
    """Read, decode and preprocess JPEG files into [N, size, size, 3]
    f32."""
    lib = _jpeg.require()
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    out = np.empty((len(paths), size, size, 3), np.float32)
    rc = lib.svt_load_preprocess_jpegs(
        arr, len(paths), out.ctypes.data_as(ctypes.c_void_p), size, mean,
        std)
    if rc != 0:
        raise RuntimeError(f"{rc}/{len(paths)} jpegs failed to load")
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8."""
    lib = _jpeg.require()
    w, h = ctypes.c_int(), ctypes.c_int()
    buf = np.frombuffer(data, np.uint8)
    if lib.svt_jpeg_dims(buf.ctypes.data_as(ctypes.c_void_p), len(data),
                         ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("not a valid JPEG")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.svt_decode_jpeg(buf.ctypes.data_as(ctypes.c_void_p), len(data),
                             out.ctypes.data_as(ctypes.c_void_p), w.value,
                             h.value)
    if rc != 0:
        raise ValueError(f"decode failed ({rc})")
    return out


def video_available() -> bool:
    return _video.load() is not None


def video_build_error() -> Optional[str]:
    _video.load()
    return _video.error


def video_info(path: str):
    """(width, height, fps, n_frames) of a video file."""
    lib = _video.require()
    w, h = ctypes.c_int(), ctypes.c_int()
    fps, n = ctypes.c_double(), ctypes.c_int64()
    rc = lib.svt_video_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(fps), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"cannot probe video {path} (rc={rc})")
    return w.value, h.value, fps.value, n.value


def video_read_frames(path: str, indices) -> np.ndarray:
    """The frames at `indices` (sorted, duplicates dropped) ->
    [n, H, W, 3] uint8."""
    lib = _video.require()
    w, h, _, total = video_info(path)
    idx = np.asarray(sorted(set(int(i) for i in indices)), np.int64)
    if not ((idx >= 0).all() and (idx < total).all()):
        raise ValueError(f"frame indices {idx.tolist()} outside "
                         f"0..{total - 1}")
    out = np.empty((len(idx), h, w, 3), np.uint8)
    got = lib.svt_video_read_frames(
        path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx), out.ctypes.data_as(ctypes.c_void_p), w, h)
    if got != len(idx):
        raise ValueError(f"decoded {got}/{len(idx)} frames from {path}")
    return out


def video_sample_frames(path: str, video_fps: float = 1.0,
                        frames_upbound: int = 0,
                        force_sample: bool = False) -> np.ndarray:
    """Frames sampled as the reference samples them: one per 1/video_fps
    seconds; past frames_upbound (or with force_sample),
    linspace(0, total - 1, frames_upbound)."""
    _, _, fps, total = video_info(path)
    stride = max(int(round((fps if fps > 0 else 30.0) / video_fps)), 1)
    idx = list(range(0, total, stride))
    if frames_upbound > 0 and (len(idx) > frames_upbound or force_sample):
        idx = np.linspace(0, total - 1, frames_upbound,
                          dtype=np.int64).tolist()
    return video_read_frames(path, idx)
