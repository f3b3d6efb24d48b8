"""Frozen-tower feature cache for grounding training.

Counterpart of videoitg_tpu/train/feature_cache.py. The SigLIP tower is
frozen in every released recipe, so its per-frame outputs are a pure
function of (video bytes, sampling parameters, tower weights). Caching them
on disk lets epoch >= 2, and every re-run over the same data, skip video
decode, preprocessing and the tower forward.

Layout: one `<key>.npz` per (video, sampling, tower) under the cache
directory, written atomically (temporary name + rename). The layout and the
key are the JAX package's, so an entry written by either package is read by
the other; only the tower fingerprint, which goes into the key, differs
between the two (each hashes its own parameter names).

Storage dtypes:
  bf16 (default): exact for a bf16 training tower, 2 bytes an element.
  int8:           per-(frame, patch) symmetric rows + fp32 scales, 4x
                  smaller, ~0.4% feature error.
Features are stored before the pool (tower output [T, P, C]), so the
training-time random-hw draw of the projector is unaffected.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.train.dataset import GroundingDataset, GroundingSample


def _leaf_bytes(t: torch.Tensor) -> bytes:
    flat = t.detach().reshape(-1)[:64].cpu().contiguous()
    if flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    return flat.numpy().tobytes()


def params_fingerprint(vision: nn.Module) -> str:
    """Cheap content fingerprint of the tower weights: every leaf's name,
    shape, dtype and the bytes of its first 64 elements. Enough to invalidate
    the cache when another checkpoint (or a re-init) is loaded, without
    hashing gigabytes."""
    h = hashlib.sha1()
    for name, leaf in sorted(vision.state_dict().items()):
        h.update(name.encode())
        h.update(str(tuple(leaf.shape)).encode() + str(leaf.dtype).encode())
        h.update(_leaf_bytes(leaf))
    return h.hexdigest()


def _to_bf16_bits(feats: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(feats)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.view(torch.bfloat16).float().numpy()


class FeatureCache:
    def __init__(self, directory: str, store_dtype: str = "bf16"):
        if store_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown feature-cache dtype {store_dtype!r}")
        self.directory = directory
        self.store_dtype = store_dtype
        os.makedirs(directory, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def key(self, video_path: str, video_frames: int, fps: float,
            cfg: GroundingConfig, tower_fp: str) -> str:
        try:
            st = os.stat(video_path)
            ident = (os.path.abspath(video_path), st.st_size, int(st.st_mtime))
        except OSError:
            ident = (os.path.abspath(video_path), -1, -1)
        v = cfg.vision
        payload = json.dumps([
            ident, video_frames, fps, tower_fp,
            [v.arch, v.hidden_size, v.num_layers, v.image_size,
             v.patch_size, v.select_layer],
        ])
        return hashlib.sha1(payload.encode()).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".npz")

    def get(self, key: str) -> Optional[np.ndarray]:
        """The entry as float32 [T, P, C], or None on a miss. An unreadable
        entry is dropped and counts as a miss."""
        path = self._path(key)
        if not os.path.exists(path):
            self.misses += 1
            return None
        try:
            with np.load(path) as z:
                if z["dtype"] == "int8":
                    feats = z["q"].astype(np.float32) * z["scale"][..., None]
                else:  # bf16 stored as its uint16 bit pattern
                    feats = _from_bf16_bits(z["bits"])
        except Exception as e:  # truncated or corrupt entry -> recompute
            print(f"[feature-cache] dropping unreadable entry {path}: {e}")
            try:
                os.remove(path)
            except OSError:
                pass
            self.misses += 1
            return None
        self.hits += 1
        return feats

    def put(self, key: str, feats: np.ndarray) -> None:
        feats = np.asarray(feats, dtype=np.float32)
        path = self._path(key)
        tmp = path + f".tmp.{os.getpid()}"
        # np.savez appends ".npz" to a string name: write through a handle so
        # that the temporary file lands where os.replace expects it.
        with open(tmp, "wb") as f:
            if self.store_dtype == "int8":
                scale = np.maximum(np.abs(feats).max(axis=-1), 1e-8) / 127.0
                q = np.clip(np.rint(feats / scale[..., None]), -127, 127).astype(np.int8)
                np.savez(f, dtype="int8", q=q, scale=scale.astype(np.float32))
            else:
                np.savez(f, dtype="bf16", bits=_to_bf16_bits(feats))
        os.replace(tmp, path)

    def stats(self) -> str:
        total = self.hits + self.misses
        return f"{self.hits}/{total} hits" if total else "empty"


def make_tower_fn(model: nn.Module, cfg: GroundingConfig, chunk: int = 128, use_flash=False):
    """Frozen-tower runner: uint8 frames [T, H, W, 3] (numpy) -> features
    [T, P, C] float32 (numpy), `chunk` frames at a time on the tower's
    device. Pixels are preprocessed in bf16, as the JAX package does, and
    then follow the tower's dtype."""
    from videoitg_tpu_torch.models.siglip import siglip_features
    from videoitg_tpu_torch.ops.preprocess import preprocess_frames

    vision = model.vision
    weight = vision.patch_embed.w

    @torch.no_grad()
    def tower(frames: np.ndarray) -> np.ndarray:
        outs = []
        for lo in range(0, frames.shape[0], chunk):
            x = torch.from_numpy(np.ascontiguousarray(frames[lo:lo + chunk])).to(weight.device)
            x = preprocess_frames(x, out_size=cfg.vision.image_size, dtype=torch.bfloat16)
            feats = siglip_features(vision, x.to(weight.dtype), cfg.vision, use_flash=use_flash)
            outs.append(feats.float().cpu().numpy())
        return np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]

    return tower


class CachedFeatureDataset:
    """GroundingDataset wrapper that yields tower features, not pixels.

    Hit: skips decode, preprocessing and the tower (the text is tokenised
    again, which is cheap). Miss: decodes through the wrapped dataset, runs
    the frozen tower on whatever thread pulls the sample (so under
    `prefetch_batches` the fill overlaps the train step) and writes the
    entry. Samples come back as `GroundingSample` with `frames` = [T, P, C]
    float32.
    """

    def __init__(self, dataset: GroundingDataset, cache: FeatureCache, model: nn.Module,
                 cfg: GroundingConfig, chunk: int = 128, use_flash=False):
        self.dataset = dataset
        self.cache = cache
        self.cfg = cfg
        self.tower = make_tower_fn(model, cfg, chunk=chunk, use_flash=use_flash)
        self.tower_fp = params_fingerprint(model.vision)
        self._by_path = {
            os.path.join(dataset.image_folder, r["video"]): r
            for r in dataset.records if "video" in r
        }

    def __len__(self) -> int:
        return len(self.dataset)

    def modality_lengths(self):
        return self.dataset.modality_lengths()

    def _key_for(self, rec) -> str:
        video_path = os.path.join(self.dataset.image_folder, rec["video"])
        return self.cache.key(video_path, self.dataset.video_frames,
                              self.dataset.fps, self.cfg, self.tower_fp)

    def __getitem__(self, i: int) -> GroundingSample:
        from videoitg_tpu_torch.data.tokenizer import grounding_text_ids

        rec = self.dataset.records[i]
        if "video" in rec and "clip_num" in rec:
            feats = self.cache.get(self._key_for(rec))
            if feats is not None:
                t = feats.shape[0]
                labels = np.zeros((t,), dtype=np.float32)
                for clip in rec["clip_num"]:
                    if 0 <= clip < t:
                        labels[clip] = 1.0
                question = rec["question"].replace("<image>\n", "")
                text_ids = grounding_text_ids(
                    question, self.dataset.tokenizer, self.cfg.max_text_len)
                return GroundingSample(
                    feats, text_ids, labels,
                    os.path.join(self.dataset.image_folder, rec["video"]))

        # Miss (or a record the wrapped dataset resampled): decode, tower, fill.
        sample = self.dataset[i]
        feats = self.tower(sample.frames)
        # Key by the record that was actually loaded (a decode failure
        # resamples to another video).
        rec2 = self._by_path.get(sample.video_path)
        if rec2 is not None and "clip_num" in rec2:
            self.cache.put(self._key_for(rec2), feats)
        return GroundingSample(feats, sample.text_ids, sample.labels, sample.video_path)
