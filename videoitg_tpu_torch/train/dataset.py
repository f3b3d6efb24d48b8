"""VideoITG-40K grounding dataset pipeline.

Data contract (reference train_itg.py:1008-1108): a JSON list of samples
{"video": relpath, "question": str, "clip_num": [frame positions]} —
40K videos / 500K annotations in the released set. Per sample: decode
`video_frames` frames at `fps` with the infer-path rounding
(read_video_decord, mm_utils.py:33-41), grounding_label = zeros[T] with 1
at each clip_num position, text = question via the plain template
("<image>" + question + "\\n", labels masked over the image token).

Robustness parity: decode failures retry up to 10 times with a random
resample (train_itg.py:1045-1095).

Samples are grouped by frame bucket, so that co-batched samples share their
padding shape; hw is drawn per batch on the host (mlp_proj.py:52 semantics)
from the same `random.Random` that shuffles, so the order of calls decides
the hw sequence.

Counterpart of videoitg_tpu/train/dataset.py, which has no JAX in it: the
same code on the port's own config, sampling, tokenizer and video reader.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.data.sampling import TRAIN_FRAME_BUCKETS, frame_bucket
from videoitg_tpu_torch.data.tokenizer import grounding_text_ids
from videoitg_tpu_torch.models.projector import training_hw


@dataclass
class GroundingSample:
    frames: np.ndarray          # [T, H, W, 3] uint8, or [T, P, C] tower features
    text_ids: List[int]
    labels: np.ndarray          # [T] float32 0/1
    video_path: str


class GroundingDataset:
    def __init__(
        self,
        data_path: str,
        image_folder: str,
        tokenizer,
        cfg: GroundingConfig,
        video_frames: int = 1024,
        fps: float = 1.0,
        max_attempts: int = 10,
        seed: int = 0,
        pix_fmt: str = "rgb",
    ):
        with open(data_path) as f:
            self.records = json.load(f)
        self.image_folder = image_folder
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.video_frames = video_frames
        self.fps = fps
        self.max_attempts = max_attempts
        self.rng = random.Random(seed)
        self.pix_fmt = pix_fmt

    def __len__(self) -> int:
        return len(self.records)

    def modality_lengths(self) -> List[int]:
        """Sampler grouping lengths (reference train_itg.py:1033-1041)."""
        out = []
        for r in self.records:
            if "question" in r:
                out.append(len(r["question"].split()))
            else:
                out.append(
                    sum(len(c["value"].split()) for c in r.get("conversations", []))
                )
        return out

    def _load_one(self, i: int) -> GroundingSample:
        from videoitg_tpu_torch.data.video import read_video_frames

        rec = self.records[i]
        video_path = os.path.join(self.image_folder, rec["video"])
        frames, _sampled = read_video_frames(
            video_path, num_frames=self.video_frames, target_fps=self.fps,
            sampling="infer", pix_fmt=self.pix_fmt,
        )
        t = frames.shape[0]
        labels = np.zeros((t,), dtype=np.float32)
        for clip in rec["clip_num"]:
            if 0 <= clip < t:
                labels[clip] = 1.0
        question = rec["question"].replace("<image>\n", "")
        text_ids = grounding_text_ids(question, self.tokenizer, self.cfg.max_text_len)
        return GroundingSample(frames, text_ids, labels, video_path)

    def __getitem__(self, i: int) -> GroundingSample:
        for attempt in range(self.max_attempts):
            try:
                return self._load_one(i)
            except Exception as e:  # decode failure -> random resample
                print(f"[dataset] error loading sample {i} "
                      f"(attempt {attempt + 1}): {e}")
                i = self.rng.randint(0, len(self.records) - 1)
        raise RuntimeError("exceeded max decode retries")


def prefetch_batches(batches: Iterator[tuple], depth: int = 2) -> Iterator[tuple]:
    """Run a batch iterator on a background thread, `depth` batches ahead.

    The reference trains with 6 DataLoader workers per rank
    (train_itg.py dataloader_num_workers); here ONE producer thread is
    enough because the in-tree libav decoder releases the GIL — video
    decode for step i+1 overlaps step i's device time. Exceptions in the
    producer re-raise at the consumer's next pull.
    """
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        # Bounded put that gives up when the consumer is gone — otherwise
        # an early consumer exit (step limit hit) would leave the producer
        # blocked forever holding decoded frame batches.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def fill():
        try:
            for item in batches:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as e:  # surfaced on the consumer side
            put(e)

    threading.Thread(target=fill, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()  # generator closed early: release the producer


def make_batches(
    dataset: GroundingDataset,
    batch_size: int,
    cfg: GroundingConfig,
    epochs: int = 1,
    seed: int = 0,
    buckets: Sequence[int] = TRAIN_FRAME_BUCKETS,
) -> Iterator[tuple]:
    """Yield (t_bucket, hw, list[GroundingSample]) batches, length-grouped.

    Like the reference's LengthGroupedSampler (eagle_trainer.py:62-132):
    shuffle, then group so that co-batched samples share their padding
    shape; here the grouping is by frame bucket.
    """
    rng = random.Random(seed)
    for _epoch in range(epochs):
        order = list(range(len(dataset)))
        rng.shuffle(order)
        pending: dict = {}
        for i in order:
            sample = dataset[i]
            b = frame_bucket(sample.frames.shape[0], buckets)
            pending.setdefault(b, []).append(sample)
            if len(pending[b]) == batch_size:
                batch = pending.pop(b)
                hw = training_hw(
                    cfg.projector, max(s.frames.shape[0] for s in batch),
                    cfg.vision.num_patches_per_side, rng,
                )
                yield b, hw, batch
        for b, batch in pending.items():  # flush leftovers
            if batch:
                hw = training_hw(
                    cfg.projector, max(s.frames.shape[0] for s in batch),
                    cfg.vision.num_patches_per_side, rng,
                )
                yield b, hw, batch
