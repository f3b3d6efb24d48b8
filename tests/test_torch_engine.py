"""The port's selection path as a whole against the JAX engine.

Both engines get the same `init_grounding` weights (through the bridge), the
same tokenizer and the same uint8 frames. fp32 on the CPU; the Top-K `index`
must be identical and `raw_scores` agree within atol 2e-5
(tests/test_engine.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoitg_tpu.config import GroundingConfig, preset
from videoitg_tpu.data.video import write_test_video
from videoitg_tpu.engine import SelectionEngine as JaxEngine
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu.utils.common import CharTokenizer
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.config import preset as port_preset
from videoitg_tpu_torch.engine import SelectionEngine
from videoitg_tpu_torch.models.grounding import GroundingBatch, grounding_logits

ATOL = 2e-5
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "tiny_scores.json")


@pytest.fixture(scope="module")
def tiny():
    cfg = preset("tiny")
    params = jax_init_grounding(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), port_preset("tiny"))
    return cfg, params, model


def _engines(tiny, use_flash, **kw):
    cfg, params, model = tiny
    kw = dict(dict(buckets=(4, 8), num_frames=8), **kw)
    tok = CharTokenizer(cfg.lm.vocab_size)
    jax_engine = JaxEngine(params, cfg, tok, dtype=jnp.float32, use_flash=False, **kw)
    port = SelectionEngine(model, port_preset("tiny"), tok, device="cpu", dtype=torch.float32,
                           use_flash=use_flash, **kw)
    return jax_engine, port


def _frames(rng, t, size=56):
    return rng.integers(0, 256, (t, size, size, 3), dtype=np.uint8)


def _same_result(got, want):
    assert got.index == want.index
    np.testing.assert_allclose(got.raw_scores, want.raw_scores, atol=ATOL, rtol=0)
    assert got.to_reference_json().keys() == want.to_reference_json().keys()
    np.testing.assert_allclose(got.logits, want.logits, atol=0.01 + 1e-9)
    assert got.topk(3) == want.topk(3)


@pytest.mark.parametrize("use_flash", [False, True])
def test_select_matches_jax_engine(tiny, use_flash):
    jax_engine, port = _engines(tiny, use_flash)
    rng = np.random.default_rng(0)
    frames = _frames(rng, 6)  # 6 real frames in the 8-bucket
    sampled = [0, 10, 20, 30, 40, 50]
    want = jax_engine.select(frames, sampled, "what happens next?", video_path="x.mp4", doc_id=3)
    got = port.select(frames, sampled, "what happens next?", video_path="x.mp4", doc_id=3)
    _same_result(got, want)
    assert sorted(got.index) == sampled and got.num_frames == 1 and got.doc_id == 3


@pytest.mark.parametrize("use_flash", [False, True])
def test_score_frames_batch_of_two_matches_jax(tiny, use_flash):
    jax_engine, port = _engines(tiny, use_flash, buckets=(4,))
    rng = np.random.default_rng(1)
    videos = [_frames(rng, 4), _frames(rng, 3)]
    instructions = ["first question", "a second, longer question"]
    want = jax_engine.score_frames(videos, instructions)
    got = port.score_frames(videos, instructions)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    single = port.score_frames(videos[1:], instructions[1:])[0]
    np.testing.assert_allclose(single, got[1], atol=ATOL, rtol=0)


def test_select_many_matches_jax(tiny):
    jax_engine, port = _engines(tiny, False)
    rng = np.random.default_rng(2)
    frames = _frames(rng, 5)
    sampled = list(range(0, 50, 10))
    questions = ["who enters?", "where is the red car", "what is on the table at the end?"]
    want = jax_engine.select_many(frames, sampled, questions, doc_ids=[1, 2, 3])
    got = port.select_many(frames, sampled, questions, doc_ids=[1, 2, 3])
    assert len(got) == 3
    for g, w in zip(got, want):
        _same_result(g, w)
        assert g.doc_id == w.doc_id and g.contexts == w.contexts
    # Reusing the tower features scores exactly like the fused path.
    fused = port.score_frames([frames], [questions[1]])[0]
    np.testing.assert_allclose(got[1].raw_scores, fused, atol=ATOL, rtol=0)


def test_golden_tiny_scores():
    """The three pinned tiny cases of tests/golden/tiny_scores.json at 1e-4
    (tests/test_golden.py), on JAX-initialised weights through the bridge."""
    cfg = GroundingConfig.tiny()
    params = jax_init_grounding(jax.random.PRNGKey(1234), cfg, dtype=jnp.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    rng = np.random.default_rng(1234)
    got = []
    for t_real, t_bucket, hw, l_txt in [(4, 4, 2, 8), (3, 8, 2, 5), (6, 8, 1, 12)]:
        frames = np.zeros((1, t_bucket, 56, 56, 3), dtype=np.float32)
        frames[0, :t_real] = rng.standard_normal((t_real, 56, 56, 3))
        fv = np.zeros((1, t_bucket), dtype=bool)
        fv[0, :t_real] = True
        ids = np.zeros((1, 16), dtype=np.int64)
        ids[0, :l_txt] = rng.integers(0, 500, l_txt)
        tv = np.zeros((1, 16), dtype=bool)
        tv[0, :l_txt] = True
        batch = GroundingBatch(*(torch.from_numpy(a) for a in (frames, fv, ids, tv)))
        logits = grounding_logits(model, batch, cfg, hw=hw)[0, :t_real]
        got.append({"t_real": t_real, "hw": hw, "logits": logits.tolist()})
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["t_real"] == w["t_real"] and g["hw"] == w["hw"]
        np.testing.assert_allclose(g["logits"], w["logits"], atol=1e-4, rtol=1e-4)


def test_select_from_file_matches_jax(tiny, tmp_path):
    path = write_test_video(str(tmp_path / "v.mp4"), 100, 76, 30, 10, 8)
    jax_engine, port = _engines(tiny, False, target_fps=10.0)
    want = jax_engine.select_from_file(path, "which frame?")
    got = port.select_from_file(path, "which frame?")
    assert got.sampled_frames == want.sampled_frames and got.video_path == path
    _same_result(got, want)


def test_preprocess_ahead_matches_inline(tiny):
    _, port = _engines(tiny, False, buckets=(8,))
    rng = np.random.default_rng(7)
    frames = _frames(rng, 6)
    inline = port.score_frames([frames], ["q"])[0]
    pre = port.preprocess_ahead(frames)
    assert pre.shape[0] == 6 and pre.pix.shape[0] == 8
    np.testing.assert_array_equal(port.score_frames([pre], ["q"])[0], inline)
    _, port4 = _engines(tiny, False, buckets=(4,))
    with pytest.raises(ValueError, match="bucket"):
        port4.score_frames([pre], ["q"])


def test_engine_rejects_what_is_not_ported(tiny):
    cfg, _, model = tiny
    tok = CharTokenizer(cfg.lm.vocab_size)
    assert SelectionEngine(model, cfg, tok, transfer="yuv420").transfer == "yuv420"
    with pytest.raises(ValueError, match="transfer"):  # as the JAX engine refuses it
        SelectionEngine(model, cfg, tok, transfer="nv12")
    with pytest.raises(NotImplementedError):
        SelectionEngine(model, cfg, tok, mesh=object())
    port = SelectionEngine(model, cfg, tok, dtype=torch.float32, buckets=(32, 64))
    rng = np.random.default_rng(3)
    with pytest.raises(ValueError, match="share hw"):  # 16 and 32 frames: hw 2 and 1
        port.score_frames([_frames(rng, 16), _frames(rng, 32)], ["a", "b"])


def test_cli_select_in_process(tmp_path, capsys):
    from videoitg_tpu_torch.cli.select import main

    path = write_test_video(str(tmp_path / "v.mp4"), 100, 76, 30, 10, 8)
    argv = ["--preset", "tiny", "--random-init", "--video", path, "--prompt", "q",
            "--device", "cpu", "--num-frames", "8", "--target-fps", "10"]
    assert main(argv + ["--json"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(record) == {"index", "logits", "num_frames", "contexts", "video_path", "doc_id"}
    assert len(record["index"]) == 8 and len(set(record["index"])) == 8
    assert record["logits"] == sorted(record["logits"], reverse=True)
    assert main(argv + ["--topk", "3"]) == 0
    top = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert top == sorted(record["index"][:3])
    assert main(argv + ["--quantize", "int8"]) == 0
    assert len(json.loads(capsys.readouterr().out.strip().splitlines()[-1])) == 8
    assert main(argv + ["--export-serving", str(tmp_path / "out")]) == 2
    assert main(argv + ["--json", "--transfer", "yuv420"]) == 0
    yuv = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(yuv["index"]) == sorted(record["index"])


def test_engine_stays_on_the_models_device_unless_told(tiny):
    """No `device` argument means the device the caller put the model on, never
    a silent move to the CPU (a model on the card must be served on the card).
    The `meta` device stands in for a card here."""
    import copy

    cfg, _, model = tiny
    tok = CharTokenizer(cfg.lm.vocab_size)
    elsewhere = copy.deepcopy(model).to("meta")
    engine = SelectionEngine(elsewhere, cfg, tok, dtype=torch.float32)
    assert engine.device.type == "meta"
    assert next(engine.model.parameters()).device.type == "meta" and engine.use_flash is False
    assert SelectionEngine(model, cfg, tok, dtype=torch.float32).device.type == "cpu"
    moved = SelectionEngine(copy.deepcopy(model).to("meta"), cfg, tok, device="meta",
                            dtype=torch.float32)
    assert moved.device.type == "meta"
