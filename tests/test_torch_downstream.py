"""The port's downstream (stage B) adapters against the JAX package's, on the
offline fixture checkpoints of tests/fixtures/build.py and the stub
chat-completions server of tests/test_api_chat.py.

Each pair of adapters is built with the same arguments (the port's with
`device="cpu"`), runs the same Video-MME docs through its own harness, and
must give the same responses, decode the same frame ids for each doc, and,
for `api-chat`, send the same payloads. Every comparison is for equality.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_api_chat import _Stub
from videoitg_tpu.eval.api import get_adapter as jax_get_adapter
from videoitg_tpu.eval.api import get_task as jax_get_task
from videoitg_tpu.eval.harness import evaluate_task as jax_evaluate_task
from videoitg_tpu_torch.data.video import write_test_video
from videoitg_tpu_torch.eval.api import get_adapter, get_task
from videoitg_tpu_torch.eval.harness import evaluate_task


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("downstream")
    os.makedirs(d / "data")
    for i in range(3):
        write_test_video(str(d / "data" / f"vid{i}.mp4"), 64, 48, 30 + 5 * i, 10, 8)
    # doc 0 and 1 have stage-A rows (doc 1's with a repeated id), doc 2 none
    rows = [{"doc_id": 0, "index": [5, 1, 9, 3], "logits": [0.9, 0.8, 0.7, 0.6]},
            {"doc_id": 1, "index": [7, 7, 2, 30], "logits": [0.9, 0.9, 0.8, 0.7]}]
    for r in rows:
        r.update(num_frames=1, contexts="q", video_path="x.mp4")
    (d / "results.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return d


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from tests.fixtures.build import build_tiny_internvl, build_tiny_llava

    d = tmp_path_factory.mktemp("ckpts")
    return {"internvl": build_tiny_internvl(str(d / "internvl")),
            "llava": build_tiny_llava(str(d / "llava"))}


def _docs():
    return [{"videoID": f"vid{i}", "question_id": f"q{i}",
             "question": ["what color is the video", "when does the key moment happen",
                          "describe the video"][i],
             "options": ["A. red", "B. green", "C. blue", "D. black"],
             "answer": "ABC"[i], "duration": "short", "domain": "d",
             "sub_category": "s", "task_type": "t"} for i in range(3)]


def _recording(adapter):
    """Records the frame ids the adapter decodes for each doc."""
    seen = {}
    frames_for_doc = adapter.frames_for_doc

    def spy(doc_id, video_path, window=None):
        frames, ids = frames_for_doc(doc_id, video_path, window=window)
        seen[doc_id] = (list(ids), frames.shape)
        return frames, ids

    adapter.frames_for_doc = spy
    return seen


def _run_both(name, root, tmp_path, **kw):
    kw = dict(frame_indices_jsonl=str(root / "results.jsonl"), data_root=str(root), **kw)
    jax_adapter = jax_get_adapter(name)(**kw)
    port = get_adapter(name)(device="cpu", **kw)
    assert type(port).__name__ == type(jax_adapter).__name__
    jax_seen, port_seen = _recording(jax_adapter), _recording(port)
    want = jax_evaluate_task(jax_adapter, jax_get_task("videomme"), _docs(),
                             str(tmp_path / "jax"), log_samples=True)
    got = evaluate_task(port, get_task("videomme"), _docs(), str(tmp_path / "port"),
                        log_samples=True)
    assert [s["response"] for s in got.samples] == [s["response"] for s in want.samples]
    assert got.metrics == want.metrics and got.num_docs == want.num_docs == 3
    assert port_seen == jax_seen and len(port_seen) == 3
    return port, port_seen, [s["response"] for s in got.samples]


CASES = {
    "internvl-chat": ("internvl", dict(num_frame=3, use_fast=True), [1, 5, 9]),
    "qwen-vl-chat": ("llava", dict(num_frame=3, max_new_tokens=3), [1, 5, 9]),
    "llava-ov-chat": ("llava", dict(num_frame=3, max_new_tokens=3), [1, 5, 9]),
    "hf-video-llm-internvl": ("internvl", dict(num_frame=2, use_fast=True), [1, 5]),
    "hf-video-llm-llava": ("llava", dict(num_frame=2, max_new_tokens=2), [1, 5]),
}


@pytest.mark.parametrize("case", CASES)
def test_hf_adapters_equal_the_jax_adapters(root, ckpts, tmp_path, case):
    ckpt, kw, first_ids = CASES[case]
    name = "hf-video-llm" if case.startswith("hf-video-llm") else case
    port, seen, responses = _run_both(name, root, tmp_path, pretrained=ckpts[ckpt], **kw)
    assert port.device == torch.device("cpu") and port.model.device.type == "cpu"
    assert port.model.dtype == torch.bfloat16
    assert seen[0][0] == first_ids  # stage A's first num_frame, ascending
    # doc 1's row repeats id 7: llava-ov-chat drops the duplicate
    want_1 = {"llava-ov-chat": [2, 7], "hf-video-llm-internvl": [7, 7],
              "hf-video-llm-llava": [7, 7]}.get(case, [2, 7, 7])
    assert seen[1][0] == want_1
    total = 40  # vid2: uniform fallback over its 40 frames
    assert seen[2][0] == np.linspace(0, total - 1, kw["num_frame"], dtype=int).tolist()
    assert all(isinstance(r, str) and r for r in responses)


def test_echo_answer_equals_the_jax_adapter(root, tmp_path):
    port, seen, responses = _run_both("echo-answer", root, tmp_path, num_frame=2)
    assert responses == ["A (frames=[1, 5])", "A (frames=[7, 7])", "A (frames=[0, 39])"]


def test_echo_answer_window_and_qwen_fps_equal(root):
    """Task windows and the qwen_fps sampling pick the same frames in both
    packages."""
    video = str(root / "data" / "vid1.mp4")
    for kw in (dict(num_frame=4), dict(num_frame=4, sampling="qwen_fps", fps=2.0,
                                       min_frames=4, max_frames=16)):
        jax_adapter, port = jax_get_adapter("echo-answer")(**kw), get_adapter("echo-answer")(**kw)
        for window in (None, (1.5, 1.0), (10, 6, "frame"), (100.0, 0.2)):
            (_, want), (_, got) = (a.frames_for_doc(9, video, window=window)
                                   for a in (jax_adapter, port))
            assert got == want, (kw, window)
            assert port.last_metadata == jax_adapter.last_metadata


def _stub_adapters(stub, root, **kw):
    kw = dict(model="gpt-4o", api_url=stub.url, api_key="sk-test", num_frame=3,
              retry_sleep=0.0, frame_indices_jsonl=str(root / "results.jsonl"),
              data_root=str(root), **kw)
    return jax_get_adapter("api-chat")(**kw), get_adapter("api-chat")(device="cpu", **kw)


def test_api_chat_sends_the_jax_adapters_payloads(root, tmp_path):
    stub = _Stub()
    try:
        payloads = {}
        for tag, adapter, evaluate, task in zip(
                ("jax", "port"), _stub_adapters(stub, root, image_size=32),
                (jax_evaluate_task, evaluate_task), (jax_get_task, get_task)):
            stub.requests.clear()
            report = evaluate(adapter, task("videomme"), _docs(), str(tmp_path / tag),
                              log_samples=True)
            assert [s["response"] for s in report.samples] == ["A", "A", "A"]
            payloads[tag] = list(stub.requests)
        assert payloads["port"] == payloads["jax"] and len(payloads["port"]) == 3
        content = payloads["port"][0]["payload"]["messages"][0]["content"]
        assert sum(c["type"] == "image_url" for c in content) == 3
    finally:
        stub.close()


def test_api_chat_retries_and_cache_equal(root, tmp_path):
    """One failure then success, and the continual-mode response cache, give
    the same requests and responses in both packages."""
    stub = _Stub()
    try:
        for tag in ("jax", "port"):
            stub.requests.clear()
            stub.fails_left = 1
            cache = str(tmp_path / f"{tag}.json")
            a = _stub_adapters(stub, root, image_size=16, retries=3,
                               response_cache=cache)[tag == "port"]
            task = (jax_get_task if tag == "jax" else get_task)("videomme")
            evaluate = jax_evaluate_task if tag == "jax" else evaluate_task
            first = evaluate(a, task, _docs()[:2], str(tmp_path / f"{tag}1"), log_samples=True)
            again = evaluate(a, task, _docs()[:2], str(tmp_path / f"{tag}2"), log_samples=True)
            assert [s["response"] for s in first.samples] == ["A", "A"]
            assert [s["response"] for s in again.samples] == ["A", "A"]
            assert len(stub.requests) == 3  # one failure, two answers, then the cache
            assert set(json.load(open(cache))) == {"videomme___0", "videomme___1"}
    finally:
        stub.close()


@pytest.mark.parametrize("name", ["internvl-chat", "qwen-vl-chat"])
def test_no_card_is_an_error_unless_the_cpu_is_asked(ckpts, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ckpt = ckpts["internvl" if name == "internvl-chat" else "llava"]
    with pytest.raises(SystemExit, match="no CUDA device found.*pass device=cpu"):
        get_adapter(name)(pretrained=ckpt, use_fast=True)
    # echo-answer and api-chat hold no model: they take `device` and ignore it
    get_adapter("echo-answer")(device="cuda")
