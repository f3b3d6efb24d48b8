"""MMWorld task (parity: lmms_eval/tasks/mmworld/utils.py).

Multi-discipline video MCQ. Docs: video_id / question / options (list) /
discipline / correct_answer_label. Prompt = fixed option_prompt + question
+ str(options) + post_prompt "The best answer is:"
(utils.py:85-93); scoring strips known answer prefixes then takes the
first [ABCD] (utils.py:96-115, with the 10-word guard); aggregation logs
per-discipline accuracy and returns overall percent correct
(utils.py:138-166).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

DISCIPLINES = [
    "Tech & Engineering", "Science", "Health & Medicine", "Sports & Arts",
    "Game", "Business", "Embodied Tasks",
]

_OPTION_PROMPT = (
    "Select the best answer to the following multiple-choice question based "
    "on the video and the subtitles. Respond with only the letter (A, B, C, "
    "or D) of the correct option."
)

# utils.py:98-105 — note the missing commas in the reference literal fuse
# "The best option is The correct option is" / "Best answer:Best option:"
# into single (never-matching) entries; we reproduce the effective list.
_ANSWER_PREFIXES = [
    "The best answer is",
    "The correct answer is",
    "The answer is",
    "The answer",
    "The best option isThe correct option is",
    "Best answer:Best option:",
]


def doc_to_visual(doc, data_root: str = ""):
    name = doc["video_id"].split("/")[-1] + ".mp4"
    p = os.path.join(data_root, name) if data_root else name
    if os.path.exists(p):
        return p
    for alt in (p[:-4] + ".MP4", p[:-4] + ".avi"):
        if os.path.exists(alt):
            return alt
    raise FileNotFoundError(p)


def doc_to_text(doc, post_prompt: str = "The best answer is:") -> str:
    question = doc["question"] + "\n" + str(doc["options"])
    return _OPTION_PROMPT + "\n" + question + "\n" + post_prompt


def extract_characters_regex(s: str) -> str:
    s = s.strip()
    for prefix in _ANSWER_PREFIXES:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCD]", s):
        return ""
    m = re.search(r"[ABCD]", s)
    return m[0] if m else ""


def process_results(doc, response: str) -> dict:
    return {
        "video_id": doc["video_id"],
        "discipline": doc["discipline"],
        "pred_answer": extract_characters_regex(response),
        "answer": doc["correct_answer_label"].upper(),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for category in DISCIPLINES:
        hits = [r for r in records if r["discipline"] == category]
        correct = sum(r["pred_answer"] == r["answer"] for r in hits)
        out[f"mmworld_accuracy_{category}"] = (
            100.0 * correct / len(hits) if hits else 0.0)
    correct = sum(r["pred_answer"] == r["answer"] for r in records)
    out["mmworld_accuracy"] = (
        100.0 * correct / len(records) if records else 0.0)
    return out


def load_docs(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("Xuehai/MMWorld", data_root, split)


register_task(Task(
    name="mmworld",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    primary_metric="mmworld_accuracy",
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
