"""Video decoding: ctypes binding over the native libav decoder.

Replaces the reference's decord/PyAV layer (eagle/mm_utils.py:43-79,
lmms_eval/models/videoitg.py:95-130) with one in-tree C++ library
(videoitg_tpu_torch/native/videodec.cpp): presentation-order frame indexing,
keyframe-aware batched fetch, packet-index frame counting for containers
without nb_frames — the decord contract, without the dependency.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np

from videoitg_tpu_torch.data.sampling import (
    sample_frame_indices_eval,
    sample_frame_indices_infer,
)

_LIB = None
_LIB_LOCK = threading.Lock()


def _load_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from videoitg_tpu_torch.native.build import build

        path = build()
        lib = ctypes.CDLL(path)
        lib.vdec_open.restype = ctypes.c_void_p
        lib.vdec_open.argtypes = [ctypes.c_char_p]
        lib.vdec_error.restype = ctypes.c_char_p
        lib.vdec_error.argtypes = [ctypes.c_void_p]
        lib.vdec_ok.restype = ctypes.c_int
        lib.vdec_ok.argtypes = [ctypes.c_void_p]
        lib.vdec_num_frames.restype = ctypes.c_int64
        lib.vdec_num_frames.argtypes = [ctypes.c_void_p]
        lib.vdec_fps.restype = ctypes.c_double
        lib.vdec_fps.argtypes = [ctypes.c_void_p]
        lib.vdec_width.restype = ctypes.c_int
        lib.vdec_width.argtypes = [ctypes.c_void_p]
        lib.vdec_height.restype = ctypes.c_int
        lib.vdec_height.argtypes = [ctypes.c_void_p]
        lib.vdec_get_batch.restype = ctypes.c_int
        lib.vdec_get_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vdec_get_batch_yuv.restype = ctypes.c_int
        lib.vdec_get_batch_yuv.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vdec_close.argtypes = [ctypes.c_void_p]
        lib.vdec_write_test_video.restype = ctypes.c_int
        lib.vdec_write_test_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        _LIB = lib
        return lib


class VideoDecodeError(RuntimeError):
    pass


class YUVFrames(NamedTuple):
    """Planar YUV420 frames as decoded (limited-range BT.601).

    Half the bytes of the RGB24 layout (1.5 B/px vs 3): the host skips the
    swscale colorspace pass and ships the decoder's native planes; chroma
    upsample + YUV->RGB run on the accelerator
    (ops/preprocess.yuv420_to_rgb). Shapes: y [T, H, W]; u, v
    [T, ceil(H/2), ceil(W/2)], all uint8.
    """

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray

    @property
    def num_frames(self) -> int:
        return self.y.shape[0]

    @property
    def shape(self):  # [T, H, W, 3]-compatible leading dims for callers
        t, h, w = self.y.shape
        return (t, h, w, 3)

    @property
    def nbytes(self) -> int:
        return self.y.nbytes + self.u.nbytes + self.v.nbytes


VideoFrames = Union[np.ndarray, YUVFrames]


class VideoReader:
    """decord-equivalent reader: len() = frame count, get_batch(indices)."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._lib = _load_lib()
        self._h = self._lib.vdec_open(path.encode())
        if not self._lib.vdec_ok(self._h):
            err = self._lib.vdec_error(self._h).decode()
            self._lib.vdec_close(self._h)
            self._h = None
            raise VideoDecodeError(f"{path}: {err}")
        self.path = path
        self.width = self._lib.vdec_width(self._h)
        self.height = self._lib.vdec_height(self._h)

    def __len__(self) -> int:
        return int(self._lib.vdec_num_frames(self._h))

    @property
    def fps(self) -> float:
        return float(self._lib.vdec_fps(self._h))

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Decode frames at presentation indices -> [N, H, W, 3] uint8."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self.height, self.width, 3), dtype=np.uint8)
        ret = self._lib.vdec_get_batch(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if ret != 0:
            raise VideoDecodeError(
                f"{self.path}: {self._lib.vdec_error(self._h).decode()}"
            )
        return out

    def get_batch_yuv(self, indices: Sequence[int]) -> YUVFrames:
        """Decode frames as packed YUV420 planes (half the bytes of RGB)."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        h, w = self.height, self.width
        ch, cw = (h + 1) // 2, (w + 1) // 2
        y = np.empty((len(idx), h, w), dtype=np.uint8)
        u = np.empty((len(idx), ch, cw), dtype=np.uint8)
        v = np.empty((len(idx), ch, cw), dtype=np.uint8)
        as_u8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        ret = self._lib.vdec_get_batch_yuv(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), as_u8(y), as_u8(u), as_u8(v),
        )
        if ret != 0:
            raise VideoDecodeError(
                f"{self.path}: {self._lib.vdec_error(self._h).decode()}"
            )
        return YUVFrames(y, u, v)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.get_batch([i])[0]

    def close(self):
        if self._h is not None:
            self._lib.vdec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_test_video(
    path: str, width: int = 64, height: int = 48, n_frames: int = 60,
    fps: int = 10, gop: int = 12,
) -> str:
    """Synthesize a solid-color-per-frame fixture (see videodec.cpp)."""
    lib = _load_lib()
    ret = lib.vdec_write_test_video(path.encode(), width, height, n_frames, fps, gop)
    if ret != 0:
        raise VideoDecodeError(f"test video write failed ({ret})")
    return path


def expected_fixture_color(i: int) -> Tuple[int, int, int]:
    """Expected solid color of frame i in a write_test_video fixture."""
    return (i % 200 + 20, (i * 7) % 200 + 20, (i * 13) % 200 + 20)


def read_video_frames(
    path: str,
    num_frames: int = 512,
    target_fps: float = 1.0,
    sampling: str = "eval",
    multiple: int = 1,
    pix_fmt: str = "rgb",
) -> Tuple[VideoFrames, List[int]]:
    """Decode a video with the reference's sampling math.

    sampling="eval" uses the harness rounding (videoitg.py:82-93),
    "infer" the demo/train rounding (mm_utils.py:33-41). pix_fmt="rgb"
    returns uint8 [T, H, W, 3]; "yuv420" returns YUVFrames (half the
    host->device bytes; colorspace conversion runs on device). Also
    returns the sampled original frame indices.
    """
    with VideoReader(path) as vr:
        total, fps = len(vr), vr.fps
        if sampling == "eval":
            sampled = sample_frame_indices_eval(total, fps, target_fps, num_frames, multiple)
        elif sampling == "infer":
            sampled = sample_frame_indices_infer(total, fps, target_fps, num_frames)
        else:
            raise ValueError(f"unknown sampling {sampling!r}")
        if pix_fmt == "rgb":
            frames = vr.get_batch(sampled)
        elif pix_fmt == "yuv420":
            frames = vr.get_batch_yuv(sampled)
        else:
            raise ValueError(f"unknown pix_fmt {pix_fmt!r}")
    return frames, sampled
