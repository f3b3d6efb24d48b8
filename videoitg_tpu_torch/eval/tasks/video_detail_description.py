"""Video Detail Description (video_dc499), judge-scored.

Parity: lmms_eval/tasks/video_detail_description/ — docs carry
video_name (no extension) / question / answer; prompt is the bare
question with empty default pre/post prompts (utils.py:68-80,
_default_template_yaml:6-9). Scoring sends the reference's judge
payload (utils.py:88-113 — the videochatgpt detailed-orientation
system message with its own tail: "{'score': 4.8}" example, no
double-quote typo) to the configured judge backend and parses with the
direct-literal_eval parse_score (utils.py:160-176). Metric: mean 0-5
gpt_eval_score (utils.py:204-216). Videos live in the videochatgpt
cache's Test_Videos dir (same corpus, _default_template_yaml:4).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge
from videoitg_tpu_torch.eval.tasks.videochatgpt import _DIMENSIONS

SYSTEM_MSG = _DIMENSIONS["detailed_orientation"]["system"]


def judge_messages(question: str, answer: str, pred: str) -> List[dict]:
    user = (
        "Please evaluate the following video-based question-answer "
        "pair:\n\n"
        f"Question: {question}\n"
        f"Correct Answer: {answer}\n"
        f"Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a detail orientation score "
        "where the detail orientation score is an integer value between "
        "0 and 5, with 5 indicating the highest level of detail "
        "orientation. "
        "Please generate the response in the form of a Python dictionary "
        "string with keys 'score', where its value is the detail "
        "orientation score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only "
        "provide the Python dictionary string. "
        "For example, your response should look like this: "
        "{'score': 4.8}.")
    return [{"role": "system", "content": SYSTEM_MSG},
            {"role": "user", "content": user}]


def parse_score(review: str) -> int:
    """Reference utils.py:160-176: direct literal_eval, .get('score', 0)."""
    try:
        return int(ast.literal_eval(review).get("score", 0))
    except Exception:
        return 0


# Same Test_Videos/<video_name>.{mp4,MP4,mkv} lookup as videochatgpt
# (one shared implementation; reference vdc/utils.py:165-180 does the same
# probe via str.replace, which also mangles mid-name "mp4" substrings — the
# extension-append form is equivalent for real corpus names).
from videoitg_tpu_torch.eval.tasks.videochatgpt import doc_to_visual  # noqa: E402


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = ""):
    return f"{pre_prompt}{doc['question']}{post_prompt}"


def process_results(doc, response: str) -> dict:
    pred = response if isinstance(response, str) else ""
    judge = get_judge()
    review = judge(judge_messages(doc["question"], doc["answer"], pred),
                   max_tokens=64)
    return {"video_name": doc["video_name"], "question": doc["question"],
            "answer": doc["answer"], "pred": pred,
            "score": parse_score(review), "judge_model": judge.name}


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"video_dc499_score": 0.0}
    total = 0.0
    for r in records:  # utils.py:204-216: unparseable scores count 0.0
        try:
            total += int(r["score"])
        except Exception:
            pass
    return {"video_dc499_score": total / len(records)}


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/VideoDetailDescription", data_root,
                               split)


register_task(Task(
    name="video_dc499",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    doc_id_key=None,
    primary_metric="video_dc499_score",
    generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                       "do_sample": False},
))
