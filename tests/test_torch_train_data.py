"""The port's training data path against the JAX package: `collate_grounding`
(frames and features forms), `make_batches` (the (bucket, hw, paths)
sequence from a seed), `prefetch_batches`, and the feature cache, whose
entries either package can read. CPU. The tests that decode video skip
where the libav reader cannot be built."""

import json
import os
import subprocess
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoitg_tpu.config import GroundingConfig as JaxConfig
from videoitg_tpu.train import collate as jax_collate
from videoitg_tpu.train import dataset as jax_dataset
from videoitg_tpu.train import feature_cache as jax_cache
from videoitg_tpu.utils.common import CharTokenizer as JaxTok
from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models.grounding import init_grounding
from videoitg_tpu_torch.models.projector import training_hw
from videoitg_tpu_torch.train import collate, dataset, feature_cache
from videoitg_tpu_torch.utils.common import CharTokenizer

CFG, JAX_CFG = GroundingConfig.tiny(), JaxConfig.tiny()


def _samples(rng, form, lengths, cls):
    out = []
    for i, t in enumerate(lengths):
        if form == "frames":
            fr = rng.integers(0, 256, (t, 40, 52, 3), dtype=np.uint8)
        else:
            fr = rng.standard_normal((t, CFG.vision.num_patches, CFG.vision.hidden_size)
                                     ).astype(np.float32)
        labels = (rng.random(t) < 0.5).astype(np.float32)
        ids = [int(x) for x in rng.integers(1, 500, 3 + i)]
        out.append(cls(fr, ids, labels, f"v{i}.mp4"))
    return out


@pytest.mark.parametrize("form", ["frames", "features"])
def test_collate_matches_jax(form):
    lengths = (3, 8, 11)  # padded, exact, truncated to the bucket of 8
    want = jax_collate.collate_grounding(
        _samples(np.random.default_rng(0), form, lengths, jax_dataset.GroundingSample), 8,
        JAX_CFG, dtype=jnp.float32)
    got = collate.collate_grounding(
        _samples(np.random.default_rng(0), form, lengths, dataset.GroundingSample), 8, CFG,
        dtype=torch.float32)
    assert got.frames.shape == tuple(want.frames.shape)
    if form == "features":
        assert np.array_equal(got.frames.numpy(), np.asarray(want.frames))
    else:
        np.testing.assert_allclose(got.frames.numpy(), np.asarray(want.frames), atol=1e-5)
    for field in ("frame_valid", "text_ids", "text_valid", "labels"):
        assert np.array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field))), field
    assert got.frame_valid.dtype == torch.bool and got.labels.dtype == torch.float32
    assert got.frame_valid.sum(1).tolist() == [3, 8, 8]


def test_collate_casts_and_refuses_yuv():
    from videoitg_tpu_torch.data.video import YUVFrames

    rng = np.random.default_rng(1)
    batch = collate.collate_grounding(_samples(rng, "features", (2,), dataset.GroundingSample),
                                      4, CFG)
    assert batch.frames.dtype == torch.bfloat16 and not batch.frames[0, 2:].any()
    yuv = YUVFrames(np.zeros((2, 8, 8), np.uint8), np.zeros((2, 4, 4), np.uint8),
                    np.zeros((2, 4, 4), np.uint8))
    with pytest.raises(NotImplementedError, match="yuv420"):
        collate.collate_grounding([dataset.GroundingSample(yuv, [1], np.zeros(2), "v")], 4, CFG)


@pytest.mark.parametrize("seed", range(4))
def test_training_hw_draws_match_jax(seed):
    import random

    from videoitg_tpu.models.projector import training_hw as jax_training_hw

    a, b = random.Random(seed), random.Random(seed)
    for t in (1, 2, 3, 8, 16, 64):
        assert training_hw(CFG.projector, t, 4, a) == jax_training_hw(JAX_CFG.projector, t, 4, b)


class _FakeDataset:
    """Samples without decoding: frame counts from a seed."""

    def __init__(self, cls, n=11):
        rng = np.random.default_rng(5)
        self.items = [cls(np.zeros((int(t), 2, 2, 3), np.uint8), [1], np.zeros(int(t)), f"v{i}")
                      for i, t in enumerate(rng.integers(1, 30, n))]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("seed,batch_size", [(0, 2), (1, 3), (7, 1)])
def test_make_batches_sequence_matches_jax(seed, batch_size):
    def run(mod, cls, cfg):
        return [(b, hw, [s.video_path for s in batch])
                for b, hw, batch in mod.make_batches(_FakeDataset(cls), batch_size, cfg, epochs=2,
                                                     seed=seed, buckets=(4, 8, 16, 32))]

    got = run(dataset, dataset.GroundingSample, CFG)
    assert got == run(jax_dataset, jax_dataset.GroundingSample, JAX_CFG)
    assert sum(len(paths) for _, _, paths in got) == 22 and len({hw for _, hw, _ in got}) > 1


def test_prefetch_keeps_order_and_raises_the_producers_error():
    assert list(dataset.prefetch_batches(iter(range(20)), depth=3)) == list(range(20))

    def broken():
        yield 1
        yield 2
        raise KeyError("decode failed")

    it = dataset.prefetch_batches(broken())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="decode failed"):
        next(it)
    # A consumer that stops early releases the producer thread.
    before = threading.active_count()
    gen = dataset.prefetch_batches(iter(range(1000)), depth=1)
    assert next(gen) == 0
    gen.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_feature_cache_round_trip_and_cross_package(tmp_path, store):
    feats = np.random.default_rng(2).normal(size=(3, 4, 32)).astype(np.float32)
    ours = feature_cache.FeatureCache(str(tmp_path / "ours"), store_dtype=store)
    theirs = jax_cache.FeatureCache(str(tmp_path / "theirs"), store_dtype=store)
    ours.put("k", feats)
    theirs.put("k", feats)
    got = ours.get("k")
    if store == "bf16":
        assert np.array_equal(got, feats.astype(jnp.bfloat16).astype(np.float32))
    else:
        err = np.abs(got - feats).max(axis=-1)
        assert (err <= np.abs(feats).max(axis=-1) / 127.0 + 1e-6).all()
    # Each package reads the other's entry, to the same numbers.
    cross_a = feature_cache.FeatureCache(str(tmp_path / "theirs"), store_dtype=store).get("k")
    cross_b = jax_cache.FeatureCache(str(tmp_path / "ours"), store_dtype=store).get("k")
    assert np.array_equal(cross_a, got) and np.array_equal(cross_b, got)
    assert (ours.hits, ours.misses) == (1, 0) and ours.get("absent") is None
    assert ours.misses == 1 and ours.stats() == "1/2 hits"
    # The key is the same function of the same inputs in both packages.
    video = tmp_path / "v.mp4"
    video.write_bytes(b"x" * 10)
    assert ours.key(str(video), 8, 1.0, CFG, "fp") == theirs.key(str(video), 8, 1.0, JAX_CFG, "fp")
    assert ours.key(str(video), 8, 1.0, CFG, "fp") != ours.key(str(video), 8, 1.0, CFG, "other")


def test_feature_cache_drops_a_corrupt_entry_and_rejects_a_dtype(tmp_path):
    cache = feature_cache.FeatureCache(str(tmp_path))
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    assert cache.get("bad") is None and not (tmp_path / "bad.npz").exists()
    with pytest.raises(ValueError, match="feature-cache dtype"):
        feature_cache.FeatureCache(str(tmp_path), store_dtype="fp8")


def test_params_fingerprint_follows_the_weights():
    gen = torch.Generator().manual_seed(0)
    a = init_grounding(CFG, gen)
    fp = feature_cache.params_fingerprint(a.vision)
    assert fp == feature_cache.params_fingerprint(a.vision) and len(fp) == 40
    b = init_grounding(CFG, torch.Generator().manual_seed(1))
    assert fp != feature_cache.params_fingerprint(b.vision)
    assert feature_cache.params_fingerprint(a.vision.bfloat16()) != fp


@pytest.fixture
def video_set(tmp_path):
    """Two synthetic videos and a VideoITG-format record file."""
    from videoitg_tpu_torch.data.video import write_test_video

    try:
        for name, n in (("a.mp4", 30), ("b.mp4", 60)):
            write_test_video(str(tmp_path / name), 64, 48, n, 10, 12)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the libav video reader cannot be built here: {e}")
    records = [{"video": "a.mp4", "question": "where is the dog?", "clip_num": [0, 2]},
               {"video": "b.mp4", "question": "<image>\nwhen does it turn?", "clip_num": [1, 99]}]
    (tmp_path / "data.json").write_text(json.dumps(records))
    return tmp_path


def test_dataset_and_cached_dataset_match_jax(video_set):
    kw = dict(video_frames=4, fps=1.0, seed=0)
    ours = dataset.GroundingDataset(str(video_set / "data.json"), str(video_set),
                                    CharTokenizer(512), CFG, **kw)
    theirs = jax_dataset.GroundingDataset(str(video_set / "data.json"), str(video_set),
                                          JaxTok(512), JAX_CFG, **kw)
    assert len(ours) == 2 and ours.modality_lengths() == theirs.modality_lengths()
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert np.array_equal(a.frames, b.frames) and a.text_ids == b.text_ids
        assert np.array_equal(a.labels, b.labels) and a.video_path == b.video_path

    model = init_grounding(CFG, torch.Generator().manual_seed(3))
    cache = feature_cache.FeatureCache(str(video_set / "cache"))
    cached = feature_cache.CachedFeatureDataset(ours, cache, model, CFG, chunk=2)
    first = [cached[i] for i in range(2)]
    assert (cache.hits, cache.misses) == (0, 2) and len(os.listdir(video_set / "cache")) == 2
    again = [cached[i] for i in range(2)]
    assert (cache.hits, cache.misses) == (2, 2)
    for a, b, raw in zip(first, again, (ours[0], ours[1])):
        t = raw.frames.shape[0]
        assert a.frames.shape == (t, CFG.vision.num_patches, CFG.vision.hidden_size)
        assert a.frames.dtype == np.float32
        # The hit returns the stored bf16 rounding of what the miss computed.
        want = torch.from_numpy(a.frames).to(torch.bfloat16).float().numpy()
        assert np.array_equal(b.frames, want)
        assert a.text_ids == b.text_ids == raw.text_ids and np.array_equal(b.labels, raw.labels)
    # Feature samples collate into the 4-d batch form.
    batch = collate.collate_grounding(again, 4, CFG, dtype=torch.float32)
    assert batch.frames.dim() == 4 and batch.frames.shape[:2] == (2, 4)
