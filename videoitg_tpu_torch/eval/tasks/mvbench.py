"""MVBench task (parity: lmms_eval/tasks/mvbench/utils.py).

Docs: question / candidates (option texts) / answer (the TEXT of the
correct candidate) / video (relative path). Prompt builds "(A) option\n"
lines (utils.py:93-102); scoring normalizes punctuation and accepts a bare
letter, "A. text", or letter-in-sentence (mcq_acc, utils.py:105-154);
accuracy counts only non-empty predictions (utils.py:183-199).
"""

from __future__ import annotations

import os
import re
import string
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_task

_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
          "-", ">", "<", "@", "`", ",", "?", "!"]
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")


def doc_to_visual(doc, data_root: str = ""):
    p = os.path.join(data_root, doc["video"]) if data_root else doc["video"]
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def doc_to_text(doc, post_prompt: str = "Only give the best option.\n") -> str:
    option_prompt = ""
    for i, option in enumerate(doc["candidates"]):
        option_prompt += f"({string.ascii_uppercase[i]}) {option}\n"
    return ("Question:" + doc["question"] + "\nOption:\n" + option_prompt
            + post_prompt)


def _process(answer: str) -> str:
    """mcq_acc's answer normalization (utils.py:110-152)."""
    m = re.match(r"^([A-E])\.\s*(.+)$", answer.strip(), re.IGNORECASE)
    if m:
        return m.group(1).upper()
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    out = answer
    for p in _PUNCT:
        if (p + " " in answer or " " + p in answer) or re.search(_COMMA_STRIP, answer):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out)
    out = out.strip("'").strip('"').strip(")").strip("(").strip().lower()
    m = re.search(r"\b([A-E])\b", out, re.IGNORECASE)
    return m.group(1).upper() if m else out


def process_results(doc, response: str) -> dict:
    gt_letter = None
    for i, candidate in enumerate(doc["candidates"]):
        if candidate == doc["answer"]:
            gt_letter = string.ascii_uppercase[i]
            break
    return {
        "pred_answer": response,
        "gt_answer": gt_letter,
        "score": int(_process(gt_letter or "") == _process(response)),
    }


def aggregate(records: List[dict]) -> Dict[str, float]:
    answered = [r for r in records if r["pred_answer"] != ""]
    acc = (100.0 * sum(r["score"] for r in answered) / len(answered)
           if answered else 0.0)
    return {"mvbench_accuracy": acc}


def load_docs(data_root: str, split: str = "train") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("OpenGVLab/MVBench", data_root, split)


register_task(Task(
    name="mvbench",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    process_results=process_results,
    aggregate=aggregate,
    load_docs=load_docs,
    generation_kwargs={"max_new_tokens": 16, "temperature": 0, "do_sample": False},
))
