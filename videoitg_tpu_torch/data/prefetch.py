"""Decode-ahead pipeline: overlap host video decode with device scoring.

The port's own copy of videoitg_tpu/data/prefetch.py. 512 frames a video of
host decode must not starve the card. The reference leans on torch
DataLoader workers (6 per rank); here a bounded thread pool decodes N videos
ahead while the card scores the current one (libav releases the GIL inside
decode, so threads parallelize on multi-core hosts).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Optional, Tuple


@dataclass
class DecodedItem:
    key: Any
    frames: Optional[object]       # np.ndarray [T, H, W, 3] or None on error
    sampled: Optional[list]
    error: Optional[Exception]
    meta: Any = None


def decode_ahead(
    items: Iterable[Tuple[Any, str, Any]],
    num_frames: int,
    target_fps: float,
    sampling: str = "eval",
    multiple: int = 1,
    workers: int = 2,
    ahead: int = 4,
    frame_cache=None,
    pix_fmt: str = "rgb",
    post=None,
) -> Iterator[DecodedItem]:
    """items: iterable of (key, video_path, meta). Yields DecodedItems in
    input order, decoding up to `ahead` videos ahead on `workers` threads.
    Decode errors are surfaced per-item (callers decide to skip/retry),
    mirroring the reference's per-sample robustness rather than crashing
    the whole run. `frame_cache` (data.frame_cache.FrameCache) skips decode
    for videos already sampled with this exact config. `post` (optional)
    runs on the worker thread over the decoded frames and its result
    replaces them — e.g. SelectionEngine.preprocess_ahead, which uploads and
    resizes the video from the worker thread while the scoring thread is
    busy with the previous one (its docstring says how the two are ordered)."""
    from videoitg_tpu_torch.data.frame_cache import read_video_frames_cached

    def work(item):
        key, path, meta = item
        try:
            frames, sampled = read_video_frames_cached(
                path, num_frames=num_frames, target_fps=target_fps,
                sampling=sampling, multiple=multiple, cache=frame_cache,
                pix_fmt=pix_fmt,
            )
            if post is not None:
                frames = post(frames)
            return DecodedItem(key, frames, sampled, None, meta)
        except Exception as e:  # surfaced, not raised
            return DecodedItem(key, None, None, e, meta)

    from collections import deque

    it = iter(items)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures: deque = deque()

        def fill():
            while len(futures) < ahead:
                try:
                    futures.append(pool.submit(work, next(it)))
                except StopIteration:
                    return

        fill()
        while futures:
            result = futures.popleft().result()
            fill()
            yield result
