"""Vibe-Eval (parity: lmms_eval/tasks/vibe_eval/utils.py +
vibe_eval.yaml).

Open-ended hard-prompt QA over RekaAI/VibeEval test. Docs carry
example_id / category ("difficulty-normal" | "difficulty-hard") /
prompt / reference / media_url / image.

Parity:
* doc_to_text: the stripped prompt (+ optional pre/post).
* scoring (utils.py:39-142): a judged 1-5 rating using the verbatim
  _PROMPT_WITH_IMAGE template ([Question]/[Assistant Response]/
  [Ground Truth Response]/[System] ... "Rating: (int)"); the rating is
  parsed with r"Rating:\\s*([1-5])", unparseable -> 0. The reference
  calls Reka Core with the image attached; this port sends the same
  text (+ the image as a vision part when the doc carries one)
  through eval/judge — the exact-match judge answers with a
  deterministic overlap-based rating (judge.py _rating).
* aggregation (utils.py:189-212): mean of 25*(score-1) over all
  records plus the difficulty subsets (category CONTAINMENT — "hard"
  also matches nothing else here, "normal" matches
  "difficulty-normal").
"""

from __future__ import annotations

from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task
from videoitg_tpu_torch.eval.judge import get_judge

# utils.py:39-55 — verbatim parity contract.
PROMPT_WITH_IMAGE = """\
[Question]
{prompt}

[Assistant Response]
{generation}

[Ground Truth Response]
{reference}

[System]
Rate whether the assistant response correctly matches the ground truth, in regards to the image above.
The rating should be 1-5, where 1 is incorrect and 5 is correct.
Your response should be in the format:
Explanation: (your explanation)
Rating: (int)"""


def doc_to_text(doc, pre_prompt: str = "", post_prompt: str = "") -> str:
    q = doc["prompt"].strip()
    if pre_prompt:
        q = f"{pre_prompt}{q}"
    if post_prompt:
        q = f"{q}{post_prompt}"
    return q


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc.get("image")
    if img is None:
        return None
    if hasattr(img, "convert"):
        return img
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def judge_rating(prompt: str, reference: str, generation: str,
                 image=None, judge=None) -> int:
    """utils.py:106-142 — 1-5, unparseable -> 0."""
    import re

    judge = judge or get_judge()
    text = PROMPT_WITH_IMAGE.format(prompt=prompt, reference=reference,
                                    generation=generation)
    parts = [{"type": "text", "text": text}]
    if hasattr(image, "save"):
        import base64
        import io

        buf = io.BytesIO()
        image.save(buf, format="PNG")
        parts.append({"type": "image_url", "image_url":
                      "data:image/png;base64,"
                      + base64.b64encode(buf.getvalue()).decode()})
    try:
        reply = judge([{"role": "user", "content": parts}],
                      max_tokens=1024)
    except Exception:
        return 0
    m = re.search(r"Rating:\s*([1-5])", reply or "")
    return int(m.group(1)) if m else 0


def process_results(doc, response: str) -> dict:
    return {"example_id": doc["example_id"], "category": doc["category"],
            "prompt": doc["prompt"], "generation": response,
            "score": judge_rating(doc["prompt"], doc["reference"],
                                  response, image=doc.get("image"))}


def _mean(scores: List[int]) -> float:
    return sum(25 * (s - 1) for s in scores) / len(scores)


def aggregate(records: List[dict]) -> Dict[str, float]:
    if not records:
        return {"vibe_eval_all": 0.0}
    out = {"vibe_eval_all": _mean([r["score"] for r in records])}
    for cat in ("normal", "hard"):
        sub = [r["score"] for r in records if cat in r["category"]]
        if sub:
            out[f"vibe_eval_{cat}"] = _mean(sub)
    return out


def _load(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("RekaAI/VibeEval", data_root, split)


register_task(Task(
    name="vibe_eval",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("reference"),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="vibe_eval_all",
    load_docs=_load,
    doc_id_key="example_id",
    generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                       "do_sample": False},
))
