"""The port's own copies of the framework-free modules against their originals.

`videoitg_tpu_torch` imports nothing of `videoitg_tpu`; it keeps a copy of
the config, constants, sampling, tokenizer, conversation templates, video
reader, frame cache, decode-ahead pipeline, stage timer, char tokenizer and
resize matrices. Each copy must behave exactly like the
original: every comparison here is for equality, not within a tolerance.
"""

import dataclasses

import numpy as np
import pytest

from videoitg_tpu import config as jax_config
from videoitg_tpu import constants as jax_constants
from videoitg_tpu.data import conversation as jax_conversation
from videoitg_tpu.data import frame_cache as jax_frame_cache
from videoitg_tpu.data import prefetch as jax_prefetch
from videoitg_tpu.data import sampling as jax_sampling
from videoitg_tpu.data import tokenizer as jax_tokenizer
from videoitg_tpu.data import video as jax_video
from videoitg_tpu.ops import resize as jax_resize
from videoitg_tpu.utils import common as jax_utils
from videoitg_tpu.utils import metrics_logger as jax_metrics_logger
from videoitg_tpu.utils import profiling as jax_profiling
from videoitg_tpu_torch import config, constants
from videoitg_tpu_torch.data import conversation, frame_cache, prefetch, sampling, tokenizer, video
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


def _code_lines(module):
    """The module's source without its docstrings' prose and with imports of
    either package under one name: what must be equal between the copies."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module).replace("videoitg_tpu_torch", "videoitg_tpu"))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and \
                ast.get_docstring(node) is not None:
            node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("pair", [(frame_cache, jax_frame_cache), (prefetch, jax_prefetch),
                                  (conversation, jax_conversation)],
                         ids=["frame_cache", "prefetch", "conversation"])
def test_data_path_copies_have_the_originals_code(pair):
    """Apart from docstrings and the package name in their imports, the copies
    of data/frame_cache.py, data/prefetch.py and data/conversation.py are the
    originals' code."""
    got, want = pair
    assert got.__name__.startswith("videoitg_tpu_torch.")
    assert _code_lines(got) == _code_lines(want)


@pytest.mark.parametrize("pix_fmt", ["rgb", "yuv420"])
def test_frame_cache_entries_are_shared_between_the_packages(tmp_path, pix_fmt):
    """Same key, same payload: an entry written by either package is a hit for
    the other, and both read back what the reader decoded."""
    path = video.write_test_video(str(tmp_path / "v.mp4"), 100, 76, 30, 10, 8)
    kw = dict(num_frames=8, target_fps=10.0, sampling="eval", pix_fmt=pix_fmt)
    assert frame_cache._key(path, 8, 10.0, "eval", 1, pix_fmt) == \
        jax_frame_cache._key(path, 8, 10.0, "eval", 1, pix_fmt)
    ours, theirs = frame_cache.FrameCache(str(tmp_path / "a")), \
        jax_frame_cache.FrameCache(str(tmp_path / "b"))
    frames, sampled = frame_cache.read_video_frames_cached(path, cache=ours, **kw)
    jframes, jsampled = jax_frame_cache.read_video_frames_cached(path, cache=theirs, **kw)
    assert sampled == jsampled
    hit = jax_frame_cache.FrameCache(str(tmp_path / "a")).get(path, 8, 10.0, pix_fmt=pix_fmt)
    back = frame_cache.FrameCache(str(tmp_path / "b")).get(path, 8, 10.0, pix_fmt=pix_fmt)
    assert hit is not None and back is not None and hit[1] == back[1] == sampled
    if pix_fmt == "yuv420":
        assert isinstance(back[0], video.YUVFrames) and isinstance(hit[0], jax_video.YUVFrames)
        for a, b, c in zip(frames, hit[0], back[0]):
            assert np.array_equal(a, b) and np.array_equal(a, c)
    else:
        assert np.array_equal(frames, hit[0]) and np.array_equal(jframes, back[0])
    assert ours.get(path, 4, 10.0, pix_fmt=pix_fmt) is None  # another config: a miss


def test_decode_ahead_copy_behaves_like_the_original(tmp_path):
    paths = [video.write_test_video(str(tmp_path / f"v{i}.mp4"), 64, 48, 12 + i, 10, 8)
             for i in range(3)]
    items = [(i, p, {"n": i}) for i, p in enumerate(paths)] + [(9, str(tmp_path / "no.mp4"), None)]
    kw = dict(num_frames=4, target_fps=10.0, sampling="infer", workers=2, ahead=2)
    got = list(prefetch.decode_ahead(items, post=lambda fr: fr[::-1], **kw))
    want = list(jax_prefetch.decode_ahead(items, post=lambda fr: fr[::-1], **kw))
    assert [d.key for d in got] == [d.key for d in want] == [0, 1, 2, 9]
    for g, w in zip(got[:3], want[:3]):
        assert g.error is None and g.sampled == w.sampled and g.meta == w.meta
        assert np.array_equal(g.frames, w.frames)
    assert isinstance(got[3].error, FileNotFoundError) and type(want[3].error) is type(got[3].error)
    assert type(got[0]).__module__ == "videoitg_tpu_torch.data.prefetch"


CONVERSATIONS = {
    "two turns": [{"from": "human", "value": "<image>\nwhat is shown?"},
                  {"from": "gpt", "value": "a red square"}],
    "four turns, image in the first": [
        {"from": "human", "value": "look: <image> what moves?"},
        {"from": "gpt", "value": "the car"},
        {"from": "human", "value": "and then?"},
        {"from": "gpt", "value": "it turns left\nand stops"}],
    "role / content keys, a leading system turn": [
        {"role": "system", "content": "ignored"},
        {"role": "human", "content": "<image>"},
        {"role": "gpt", "content": "ünïcödé"}],
}


@pytest.mark.parametrize("name", CONVERSATIONS)
def test_chatml_preprocessing_and_the_split_equal(name):
    convs = CONVERSATIONS[name]
    got = conversation.preprocess_chatml(convs, utils.CharTokenizer(512))
    want = jax_conversation.preprocess_chatml(convs, jax_utils.CharTokenizer(512))
    assert got == want and len(got[0]) == len(got[1])
    assert got[0].count(constants.IMAGE_TOKEN_INDEX) == 1
    a, b = conversation.split_around_image(*got), jax_conversation.split_around_image(*want)
    assert (a.pre_ids, a.post_ids, a.post_labels) == (b.pre_ids, b.post_ids, b.post_labels)
    assert len(a.post_ids) == len(a.post_labels) and a.pre_ids  # the system turn comes first
    assert type(a).__module__ == "videoitg_tpu_torch.data.conversation"
    assert conversation.CHATML_SYSTEM == jax_conversation.CHATML_SYSTEM


def test_plain_preprocessing_equal_and_refusals_alike():
    convs = CONVERSATIONS["two turns"]
    got = conversation.preprocess_plain(convs, utils.CharTokenizer(512))
    assert got == jax_conversation.preprocess_plain(convs, jax_utils.CharTokenizer(512))
    assert got[1][0] == constants.IGNORE_INDEX and got[1][1:] == got[0][1:]
    packed = conversation.split_around_image(*got)
    assert packed.pre_ids == [] and packed.post_labels == got[1][1:]
    for mod, tok in ((conversation, utils.CharTokenizer(512)),
                     (jax_conversation, jax_utils.CharTokenizer(512))):
        with pytest.raises(AssertionError):
            mod.preprocess_plain(convs[:1], tok)  # needs exactly two turns
        with pytest.raises(AssertionError):
            mod.preprocess_plain([convs[1], convs[1]], tok)  # no <image> in the first
        with pytest.raises(AssertionError, match="exactly one <image>"):
            mod.split_around_image([1, 2, 3], [1, 2, 3])


def test_native_decoder_source_is_the_original():
    """The port's libav reader is the JAX package's source line for line; only
    the package named in a comment differs."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    port = (root / "videoitg_tpu_torch" / "native" / "videodec.cpp").read_text()
    original = (root / "videoitg_tpu" / "native" / "videodec.cpp").read_text()
    assert port != original
    assert port.replace("videoitg_tpu_torch", "videoitg_tpu") == original
