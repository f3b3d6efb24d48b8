"""MovieChat-1k long-video QA (global + breakpoint modes), judge-scored.

Parity: lmms_eval/tasks/moviechat/ — docs carry video_name (with
extension) / question / answer, plus `time` (a frame index) for
breakpoint docs. Prompt is pre_prompt + question (+ empty post_prompt)
with the yaml default pre_prompt (_default_template_yaml:6-9). Scoring
sends the reference's exact judge messages (utils.py:104-131 — identical
to the ActivityNet-QA payload) to the configured judge backend
(eval/judge.py) and parses with the reference's DIRECT ast.literal_eval
parsers: parse_score -> int(.get('score', 0)), parse_acc ->
str(.get('pred', 'no')) (utils.py:171-215; no brace extraction — a
chatty judge reply scores 0/'no', faithfully). One judge call yields
both metrics (gpt_eval, utils.py:218-244). Aggregation: mean 0-5 score
and yes-fraction accuracy, neither scaled (utils.py:261-285).

Breakpoint mode: the reference's doc_to_visual returns
{"video_path", "timestep"} (utils.py:67-79) but none of its
VideoITG-path model wrappers consume the timestep — they would crash on
the dict. Here the mode is actually honored: Task.visual_window returns
(time, WINDOW_FRAMES, "frame") and frame-consuming adapters clamp
uniform sampling to that span (stage-A ITG selections still win). The
window width is an interpretation (the reference defines none);
override with VIDEOITG_BREAKPOINT_WINDOW_FRAMES.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge
from videoitg_tpu_torch.eval.tasks.activitynetqa import SYSTEM_MSG, judge_messages

# ~15 s at MovieChat-1k's 30 fps, centered on the breakpoint frame.
DEFAULT_WINDOW_FRAMES = 450

PRE_PROMPT = (
    "You are able to understand the visual content that the user "
    "provides.Follow the instructions carefully and explain your "
    "answers in detail.")

assert SYSTEM_MSG  # moviechat shares activitynetqa's judge payload verbatim


def parse_score(review: str) -> int:
    """Reference utils.py:171-186: direct literal_eval, .get('score', 0)."""
    try:
        return int(ast.literal_eval(review).get("score", 0))
    except Exception:
        return 0


def parse_acc(review: str) -> str:
    """Reference utils.py:189-203: direct literal_eval, .get('pred', 'no')."""
    try:
        return str(ast.literal_eval(review).get("pred", "no"))
    except Exception:
        return "no"


def doc_to_visual(doc, data_root: str = ""):
    """video_name carries its extension; fall back through the reference's
    mp4 -> MP4 -> mkv rename chain (utils.py:52-79)."""
    base = (os.path.join(data_root, "Test_Videos") if data_root
            else "Test_Videos")
    name = str(doc["video_name"])
    candidates = [name, name.replace("mp4", "MP4"), name.replace("mp4", "mkv")]
    for cand in candidates:
        path = os.path.join(base, cand)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(os.path.join(base, name))


def doc_to_text(doc, pre_prompt: str = PRE_PROMPT, post_prompt: str = ""):
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def visual_window(doc) -> Optional[tuple]:
    t = doc.get("time")
    if t is None:
        return None
    width = float(os.environ.get("VIDEOITG_BREAKPOINT_WINDOW_FRAMES",
                                 DEFAULT_WINDOW_FRAMES))
    return (float(t), width, "frame")


def _process_results(prefix: str):
    def process_results(doc, response: str) -> dict:
        pred = response if isinstance(response, str) else ""
        judge = get_judge()
        review = judge(judge_messages(doc["question"], doc["answer"], pred),
                       max_tokens=64)
        return {
            "video_name": doc["video_name"],
            "question": doc["question"],
            "answer": doc["answer"],
            "pred": pred,
            "time": doc.get("time"),
            "score": parse_score(review),
            "acc": parse_acc(review),
            "judge_model": judge.name,
        }

    return process_results


def _aggregate(prefix: str):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        if not records:
            return {f"{prefix}_score": 0.0, f"{prefix}_acc": 0.0}
        score = 0.0
        for r in records:  # utils.py:261-271: unparseable scores count 0.0
            try:
                score += int(r["score"])
            except Exception:
                pass
        acc = sum(1 for r in records if str(r["acc"]) == "yes")
        return {f"{prefix}_score": score / len(records),
                f"{prefix}_acc": acc / len(records)}

    return aggregate


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("Enxin/lmms_MovieChat_test", data_root, split)


for _name, _window in (("moviechat_global", None),
                       ("moviechat_breakpoint", visual_window)):
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=doc_to_text,
        process_results=_process_results(_name),
        aggregate=_aggregate(_name),
        load_docs=load_docs,
        doc_id_key=None,
        primary_metric=f"{_name}_acc",
        visual_window=_window,
        generation_kwargs={"max_new_tokens": 256, "temperature": 0,
                           "do_sample": False},
    ))

register_group("moviechat", ["moviechat_global", "moviechat_breakpoint"])
