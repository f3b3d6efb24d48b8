"""Decode-to-cache: persist sampled frames so repeated evals skip decode.

The port's own copy of videoitg_tpu/data/frame_cache.py (same keys, same
.npz payloads: either package reads the other's entries).

The grounding stage decodes 512 frames per video; across benchmark reruns
(ablations, Top-K sweeps, resumed jobs) that host decode is pure rework, and
accelerator hosts have few cores per device. Rows are keyed by
(path, size, mtime, num_frames, target_fps, sampling, multiple) so edits
or different sampling configs never alias; payloads are .npz with the
uint8 frames plus the sampled original indices.

The reference has no equivalent (its decord reader re-decodes every run);
the closest analog is its request/response caching (caching/cache.py).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Tuple

import numpy as np


def _key(path: str, num_frames: int, target_fps: float, sampling: str,
         multiple: int, pix_fmt: str = "rgb") -> str:
    st = os.stat(path)
    raw = (f"{os.path.abspath(path)}\x00{st.st_size}\x00{st.st_mtime_ns}"
           f"\x00{num_frames}\x00{target_fps}\x00{sampling}\x00{multiple}")
    if pix_fmt != "rgb":  # keep pre-existing rgb cache entries valid
        raw += f"\x00{pix_fmt}"
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


class FrameCache:
    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.npz")

    def get(self, path: str, num_frames: int, target_fps: float,
            sampling: str = "eval", multiple: int = 1, pix_fmt: str = "rgb"
            ) -> Optional[Tuple[object, List[int]]]:
        p = self._path(
            _key(path, num_frames, target_fps, sampling, multiple, pix_fmt))
        if not os.path.exists(p):
            return None
        try:
            with np.load(p) as z:
                if "y" in z:  # YUV420 planes entry
                    from videoitg_tpu_torch.data.video import YUVFrames

                    return (YUVFrames(z["y"], z["u"], z["v"]),
                            z["sampled"].tolist())
                return z["frames"], z["sampled"].tolist()
        except Exception:
            return None  # corrupt entry: treat as miss (re-decode overwrites)

    def put(self, path: str, num_frames: int, target_fps: float,
            frames, sampled: List[int],
            sampling: str = "eval", multiple: int = 1,
            pix_fmt: str = "rgb") -> None:
        key = _key(path, num_frames, target_fps, sampling, multiple, pix_fmt)
        # np.savez appends ".npz" when missing — keep the suffix explicit.
        tmp = os.path.join(self.cache_dir, f"{key}.tmp.{os.getpid()}.npz")
        arrays = (dict(y=frames.y, u=frames.u, v=frames.v)
                  if hasattr(frames, "y") else dict(frames=frames))
        np.savez(tmp, sampled=np.asarray(sampled, dtype=np.int64), **arrays)
        os.replace(tmp, self._path(key))  # atomic: safe under concurrent ranks


def read_video_frames_cached(
    path: str,
    num_frames: int = 512,
    target_fps: float = 1.0,
    sampling: str = "eval",
    multiple: int = 1,
    cache: Optional[FrameCache] = None,
    pix_fmt: str = "rgb",
) -> Tuple[object, List[int]]:
    """read_video_frames with an optional persistent decode cache."""
    from videoitg_tpu_torch.data.video import read_video_frames

    if cache is not None:
        hit = cache.get(path, num_frames, target_fps, sampling, multiple,
                        pix_fmt=pix_fmt)
        if hit is not None:
            return hit
    frames, sampled = read_video_frames(
        path, num_frames=num_frames, target_fps=target_fps,
        sampling=sampling, multiple=multiple, pix_fmt=pix_fmt)
    if cache is not None:
        cache.put(path, num_frames, target_fps, frames, sampled,
                  sampling=sampling, multiple=multiple, pix_fmt=pix_fmt)
    return frames, sampled
