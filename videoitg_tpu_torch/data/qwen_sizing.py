"""Qwen-VL dynamic-resolution sizing protocol (exact reference parity).

The reference's Qwen-style preprocessing (eagle/vision_utils.py) budgets
pixels instead of using a fixed square: frame counts are rounded to
FRAME_FACTOR (smart_nframes, vision_utils.py:125-163), and each frame is
resized so both sides divide IMAGE_FACTOR=28 while total pixels stay
inside [min_pixels, max_pixels] with aspect ratio preserved
(smart_resize, vision_utils.py:53-79). For videos the per-frame pixel cap
is additionally derived from a whole-clip budget
(fetch_video, vision_utils.py:262-266). train_itg.process_video
(train_itg.py:110-130) runs the same smart_resize over training clips.

These are pure host-side integer functions (no tensors): the TPU pipeline
consumes their outputs as STATIC shapes — bucket the (h, w) results like
frame counts are bucketed (data/sampling.frame_bucket) so XLA sees a
closed set of geometries. The SigLIP-tower VideoITG-8B path keeps its
fixed 384x384 (reference clip_encoder.py:115); these helpers serve the
Qwen2/3-VL encoder family and Qwen-protocol frame sampling.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 256 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def round_by_factor(number: float, factor: int) -> int:
    """Closest multiple of factor (vision_utils.py:38-40)."""
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    """Smallest multiple of factor >= number (vision_utils.py:43-45)."""
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    """Largest multiple of factor <= number (vision_utils.py:48-50)."""
    return math.floor(number / factor) * factor


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS,
                 max_pixels: int = MAX_PIXELS) -> Tuple[int, int]:
    """(h, w) with both sides % factor == 0, pixels in [min, max], aspect
    ratio preserved as closely as possible (vision_utils.py:53-79)."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"absolute aspect ratio must be smaller than {MAX_RATIO}, got "
            f"{max(height, width) / min(height, width)}")
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def smart_nframes(total_frames: int, video_fps: float, *,
                  nframes: Optional[int] = None,
                  fps: Optional[float] = None,
                  min_frames: Optional[int] = None,
                  max_frames: Optional[int] = None) -> int:
    """Model-input frame count for a clip (vision_utils.py:125-163).

    Either a fixed ``nframes`` (rounded to FRAME_FACTOR) or an ``fps``
    target clamped to [min_frames, max_frames] then rounded. Exactly one
    of nframes/fps may be given; neither means the default FPS=2.0.
    """
    if nframes is not None and fps is not None:
        raise ValueError("Only accept either `fps` or `nframes`")
    if nframes is not None:
        out = round_by_factor(nframes, FRAME_FACTOR)
    else:
        fps = FPS if fps is None else fps
        lo = ceil_by_factor(
            FPS_MIN_FRAMES if min_frames is None else min_frames, FRAME_FACTOR)
        hi = floor_by_factor(
            min(FPS_MAX_FRAMES, total_frames) if max_frames is None
            else max_frames, FRAME_FACTOR)
        out = total_frames / video_fps * fps
        out = min(max(out, lo), hi)
        out = round_by_factor(out, FRAME_FACTOR)
    if not (FRAME_FACTOR <= out <= total_frames):
        raise ValueError(
            f"nframes should in interval [{FRAME_FACTOR}, {total_frames}], "
            f"but got {out}.")
    return out


def video_frame_size(nframes: int, height: int, width: int, *,
                     min_pixels: Optional[int] = None,
                     total_pixels: Optional[int] = None,
                     max_pixels: Optional[int] = None,
                     image_factor: int = IMAGE_FACTOR) -> Tuple[int, int]:
    """Per-frame (h, w) under the whole-clip pixel budget
    (fetch_video, vision_utils.py:262-280): the per-frame cap is
    total_pixels / nframes * FRAME_FACTOR, floored at VIDEO_MAX_PIXELS and
    kept >= 1.05x the per-frame minimum."""
    min_px = VIDEO_MIN_PIXELS if min_pixels is None else min_pixels
    total_px = VIDEO_TOTAL_PIXELS if total_pixels is None else total_pixels
    if max_pixels is None:
        max_pixels = max(min(VIDEO_MAX_PIXELS, total_px / nframes * FRAME_FACTOR),
                         int(min_px * 1.05))
    return smart_resize(height, width, factor=image_factor,
                        min_pixels=min_px, max_pixels=max_pixels)


def train_video_size(height: int, width: int,
                     img_size: int = 0) -> Tuple[int, int]:
    """train_itg.process_video's sizing (train_itg.py:110-122): a nonzero
    img_size budgets a square; 0 budgets the native frame geometry —
    both through plain smart_resize with IMAGE defaults."""
    if img_size != 0:
        return smart_resize(img_size, img_size)
    return smart_resize(height, width)
