"""The port's own copies of the framework-free modules against their originals.

`videoitg_tpu_torch` imports nothing of `videoitg_tpu`; it keeps a copy of
the config, constants, sampling, tokenizer, video reader, stage timer, char
tokenizer and resize matrices. Each copy must behave exactly like the
original: every comparison here is for equality, not within a tolerance.
"""

import dataclasses

import numpy as np
import pytest

from videoitg_tpu import config as jax_config
from videoitg_tpu import constants as jax_constants
from videoitg_tpu.data import sampling as jax_sampling
from videoitg_tpu.data import tokenizer as jax_tokenizer
from videoitg_tpu.data import video as jax_video
from videoitg_tpu.ops import resize as jax_resize
from videoitg_tpu.utils import common as jax_utils
from videoitg_tpu.utils import metrics_logger as jax_metrics_logger
from videoitg_tpu.utils import profiling as jax_profiling
from videoitg_tpu_torch import config, constants
from videoitg_tpu_torch.data import sampling, tokenizer, video
from videoitg_tpu_torch.ops import resize
from videoitg_tpu_torch.utils import common as utils
from videoitg_tpu_torch.utils import metrics_logger, profiling

PRESETS = sorted(jax_config.PRESETS) if hasattr(jax_config, "PRESETS") else [
    "videoitg-8b", "videoitg-8b-shallow", "tiny", "dryrun-serve"]


def test_constants_equal():
    names = [n for n in dir(jax_constants) if n.isupper()]
    assert names and names == [n for n in dir(constants) if n.isupper()]
    for name in names:
        assert getattr(constants, name) == getattr(jax_constants, name), name


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equal_field_by_field(name):
    want, got = jax_config.preset(name), config.preset(name)
    assert type(got).__module__ == "videoitg_tpu_torch.config"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # derived properties the models read
    for sub, props in (("vision", ("num_patches", "num_patches_per_side", "head_dim",
                                   "num_effective_layers")),
                       ("lm", ("q_dim", "kv_dim", "head_dim"))):
        for prop in props:
            assert getattr(getattr(got, sub), prop) == getattr(getattr(want, sub), prop)
    for t in (1, 7, 32, 100, 512):
        assert got.projector.tokens_hw(t, 27) == want.projector.tokens_hw(t, 27)


def test_config_json_round_trip_equal():
    got, want = config.preset("tiny"), jax_config.preset("tiny")
    assert got.to_json() == want.to_json()
    assert dataclasses.asdict(config.GroundingConfig.from_json(want.to_json())) == \
        dataclasses.asdict(want)


def test_unknown_preset_raises_alike():
    with pytest.raises(Exception) as a:
        jax_config.preset("no-such-preset")
    with pytest.raises(type(a.value)):
        config.preset("no-such-preset")


@pytest.mark.parametrize("seed", range(5))
def test_sampling_equal_on_seeded_inputs(seed):
    rng = np.random.default_rng(seed)
    assert sampling.FRAME_BUCKETS == jax_sampling.FRAME_BUCKETS
    assert sampling.TRAIN_FRAME_BUCKETS == jax_sampling.TRAIN_FRAME_BUCKETS
    for _ in range(40):
        total = int(rng.integers(1, 20000))
        fps = float(rng.choice([10.0, 23.976, 25.0, 29.97, 30.0, 60.0]))
        target = float(rng.choice([0.5, 1.0, 2.0, 10.0]))
        n = int(rng.choice([8, 32, 512]))
        multiple = int(rng.choice([1, 2, 4]))
        assert sampling.sample_frame_indices_eval(total, fps, target, n, multiple) == \
            jax_sampling.sample_frame_indices_eval(total, fps, target, n, multiple)
        assert sampling.sample_frame_indices_infer(total, fps, target, n) == \
            jax_sampling.sample_frame_indices_infer(total, fps, target, n)
        t = int(rng.integers(1, 513))
        assert sampling.frame_bucket(t) == jax_sampling.frame_bucket(t)
        assert sampling.frame_bucket(t, (8, 600)) == jax_sampling.frame_bucket(t, (8, 600))


def test_every_public_sampling_function_is_copied():
    public = [n for n in dir(jax_sampling) if not n.startswith("_")]
    assert public == [n for n in dir(sampling) if not n.startswith("_")]


@pytest.mark.parametrize("text", ["", "what happens next?", "tabs\tand\nnewlines",
                                  "x" * 400, "ünïcödé 漢字"])
def test_grounding_text_ids_equal(text):
    tok_a, tok_b = jax_utils.CharTokenizer(512), utils.CharTokenizer(512)
    assert tok_b(text).input_ids == tok_a(text).input_ids
    assert tok_b.decode(tok_b(text).input_ids) == tok_a.decode(tok_a(text).input_ids)
    for max_len in (4, 16, 64):
        assert tokenizer.grounding_text_ids(text, tok_b, max_len) == \
            jax_tokenizer.grounding_text_ids(text, tok_a, max_len)


def test_second_image_token_is_refused_alike():
    for mod, tok in ((jax_tokenizer, jax_utils.CharTokenizer(512)),
                     (tokenizer, utils.CharTokenizer(512))):
        with pytest.raises(AssertionError, match="multiple <image>"):
            mod.grounding_text_ids("a <image> in the middle", tok, 16)


@pytest.mark.parametrize("sizes", [(27, 5), (27, 12), (27, 1), (8, 8), (5, 9)])
def test_bilinear_matrix_bit_for_bit(sizes):
    got, want = resize.bilinear_resize_matrix(*sizes), jax_resize.bilinear_resize_matrix(*sizes)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("filt", ["bicubic", "bilinear"])
@pytest.mark.parametrize("sizes", [(360, 384), (640, 384), (56, 56), (100, 30)])
def test_pil_matrix_bit_for_bit(sizes, filt):
    got = resize.pil_resample_matrix(*sizes, filt)
    want = jax_resize.pil_resample_matrix(*sizes, filt)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_stage_timer_summary_keys():
    a, b = jax_profiling.StageTimer(), profiling.StageTimer()
    for timer in (a, b):
        with timer.stage("score"):
            pass
        timer.record("decode", 0.25)
        timer.record("decode", 0.75)
    sa, sb = a.summary(), b.summary()
    assert list(sa) == list(sb) == ["decode", "score"]
    assert sa["decode"] == sb["decode"] == {"total_s": 1.0, "count": 2, "mean_ms": 500.0}
    assert sa["score"].keys() == sb["score"].keys()
    assert b.frames_per_second(10, "decode") == a.frames_per_second(10, "decode") == 10.0
    assert b.report().splitlines()[0] == "{"


def test_video_reader_copy_decodes_like_the_original(tmp_path):
    path = video.write_test_video(str(tmp_path / "v.mp4"), 100, 76, 30, 10, 8)
    for sampling_mode in ("eval", "infer"):
        got, got_idx = video.read_video_frames(path, num_frames=8, target_fps=10.0,
                                               sampling=sampling_mode)
        want, want_idx = jax_video.read_video_frames(path, num_frames=8, target_fps=10.0,
                                                     sampling=sampling_mode)
        assert got_idx == want_idx and np.array_equal(got, want)
    assert video.expected_fixture_color(7) == jax_video.expected_fixture_color(7)
    with pytest.raises(FileNotFoundError):
        video.VideoReader(str(tmp_path / "missing.mp4"))


def test_metrics_logger_copy_is_the_original(tmp_path):
    """The copy is the original's source, line for line, and writes the same
    rows (apart from the clock)."""
    import inspect
    import json

    assert inspect.getsource(metrics_logger) == inspect.getsource(jax_metrics_logger)
    rows = {}
    for name, mod in (("port", metrics_logger), ("jax", jax_metrics_logger)):
        log = mod.MetricsLogger(str(tmp_path / name), report_to="jsonl", config={"a": 1})
        log.log(1, {"loss": 0.5, "grad_norm": np.float32(2.0)})
        log.log(2, {"loss": 0.25})
        log.close()
        rows[name] = [json.loads(line) for line in open(tmp_path / name / "metrics.jsonl")]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "time"} for r in rs]  # noqa: E731
    assert strip(rows["port"]) == strip(rows["jax"]) == [
        {"step": 1, "loss": 0.5, "grad_norm": 2.0}, {"step": 2, "loss": 0.25}]
    assert all("time" in r for r in rows["port"])
