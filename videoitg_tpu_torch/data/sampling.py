"""Frame-index sampling math.

The reference ships TWO rounding variants of "uniformly pick num_frames from
an fps-strided index list" and both matter for parity because downstream
golden files are keyed by the exact frame indices:

* eval variant   — lmms_eval/models/videoitg.py:82-93 (`get_seq_frames`):
  stride = round(fps/target_fps), pick int(i*scale), pad-to-multiple with 0.
* infer/train variant — eagle/mm_utils.py:33-41 and infer.py:34-42
  (`get_frame_indices`): stride = max(1, round(fps/target_fps)),
  pick round((i+1)*scale - 1).

Both use Python round() (banker's rounding); this module runs on the host so
we simply use Python semantics. Pure functions, unit-tested.
"""

from __future__ import annotations

from typing import List, Sequence


def strided_indices(total_frames: int, original_fps: float, target_fps: float) -> List[int]:
    """Indices of frames at ~target_fps: every round(fps/target_fps)-th frame.

    The eval variant does not clamp the stride (videoitg.py:83); a stride of 0
    would crash there, so we clamp to 1 and keep behavior identical whenever
    the reference doesn't crash.
    """
    stride = max(1, round(original_fps / target_fps))
    return list(range(0, total_frames, stride))


def sample_frame_indices_eval(
    total_frames: int,
    original_fps: float,
    target_fps: float,
    num_frames: int,
    multiple: int = 1,
) -> List[int]:
    """Eval-path sampling. Parity: lmms_eval/models/videoitg.py:82-93.

    If fewer than num_frames strided indices exist, returns them all, padded
    with index 0 up to a multiple of `multiple`. Otherwise picks
    frame_idx[int(i * scale)] for i in range(num_frames).
    """
    frame_idx = strided_indices(total_frames, original_fps, target_fps)
    if len(frame_idx) < num_frames:
        while len(frame_idx) % multiple != 0:
            frame_idx.append(0)
        return frame_idx
    scale = len(frame_idx) / num_frames
    return [frame_idx[int(i * scale)] for i in range(num_frames)]


def sample_frame_indices_infer(
    total_frames: int,
    original_fps: float,
    target_fps: float,
    num_frames: int,
) -> List[int]:
    """Infer/train-path sampling. Parity: eagle/mm_utils.py:33-41, infer.py:34-42.

    Picks frame_idx[round((i+1) * scale - 1)] (Python banker's rounding).
    """
    frame_idx = strided_indices(total_frames, original_fps, target_fps)
    if len(frame_idx) < num_frames:
        return frame_idx
    scale = 1.0 * len(frame_idx) / num_frames
    uniform_idx = [round((i + 1) * scale - 1) for i in range(num_frames)]
    return [frame_idx[i] for i in uniform_idx]


def select_topk(
    scores: Sequence[float],
    sampled_indices: Sequence[int],
    k: int,
    sort_ascending: bool = True,
) -> List[int]:
    """Map per-frame scores to the Top-K original frame indices.

    Parity: infer.py:72-79 / videoitg.py:302-308 — sort scores descending
    (stable w.r.t. original order for ties, like torch.sort), map positions
    through sampled_indices, take first k, then (for the downstream decode
    contract) sort ascending.
    """
    order = sorted(range(len(scores)), key=lambda i: -scores[i])
    picked = [sampled_indices[i] for i in order[:k]]
    if sort_ascending:
        picked.sort()
    return picked


# Static frame-count buckets (one compiled shape per bucket in the JAX package;
# the port keeps them so both engines pad alike). A video with T sampled
# frames is padded up to the smallest bucket >= T; padding frames are masked
# out of attention and scoring. 512 is the reference eval setting; training
# decodes up to 1024 frames (reference finetune recipe).
FRAME_BUCKETS = (32, 64, 128, 256, 512)
TRAIN_FRAME_BUCKETS = (32, 64, 128, 256, 512, 1024)


def frame_bucket(num_frames: int, buckets: Sequence[int] = FRAME_BUCKETS) -> int:
    """Smallest bucket that holds num_frames (last bucket caps it)."""
    for b in buckets:
        if num_frames <= b:
            return b
    return buckets[-1]
