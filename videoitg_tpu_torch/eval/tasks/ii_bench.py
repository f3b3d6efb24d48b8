"""II-Bench (parity: lmms_eval/tasks/ii_bench/utils.py + ii_bench.yaml).

Image-implication MCQ over lmms-lab/II-Bench test (6 options A-F).
Docs carry id / question / option1..option6 / answer / image.

Parity:
* doc_to_text (utils.py:10-22): the fixed PROMPT template with
  pre_prompt "Instruction: Please try to answer the single-answer
  multiple choice question below based on the picture provided.\\n"
  and post_prompt "\\nAnswer:".
* extract_option_labels (utils.py:29-59): "(X)" matches first, then
  bare-letter word matches; the MOST frequent label wins with the
  LAST-listed tiebreak (candidates[-1]); if no letter, option-text
  containment votes (option in text or text in option); else None.
* The reference is submission-only (answers withheld upstream); this
  port additionally scores accuracy when the doc carries an answer so
  local fixtures produce a number (submission rows are identical).
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional

from videoitg_tpu_torch.eval.api import Task, register_task

PROMPT = """Question: {}
(A) {}
(B) {}
(C) {}
(D) {}
(E) {}
(F) {}"""

PRE_PROMPT = ("Instruction: Please try to answer the single-answer "
              "multiple choice question below based on the picture "
              "provided.\n")
POST_PROMPT = "\nAnswer:"


def extract_option_labels(text, options=None) -> Optional[str]:
    """utils.py:29-59."""
    if isinstance(text, dict):
        return "error"
    matches = re.findall(r"\(([A-F])\)", text)
    if not matches:
        matches = re.findall(r"\b([A-F])\b", text)
    if matches:
        counter = Counter(matches)
        most_common = counter.most_common()
        max_count = most_common[0][1]
        candidates = [it for it in most_common if it[1] == max_count]
        return candidates[-1][0]
    if options:
        counter = Counter()
        for i, option in enumerate(options, start=1):
            label = chr(64 + i)
            stripped = option.strip()
            if stripped in text:
                counter[label] += 1
            elif text in option:
                counter[label] += 1
        if counter:
            most_common = counter.most_common()
            max_count = most_common[0][1]
            candidates = [it for it in most_common if it[1] == max_count]
            return candidates[-1][0]
    return None


def doc_to_text(doc, pre_prompt: str = PRE_PROMPT,
                post_prompt: str = POST_PROMPT) -> str:
    q = PROMPT.format(doc["question"], doc["option1"], doc["option2"],
                      doc["option3"], doc["option4"], doc["option5"],
                      doc["option6"])
    return f"{pre_prompt}{q}{post_prompt}"


def doc_to_visual(doc, data_root: str = ""):
    import os

    img = doc["image"]
    if hasattr(img, "convert"):
        return img
    p = os.path.join(data_root, img) if data_root else img
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def process_results(doc, response: str) -> dict:
    predict = extract_option_labels(
        response, [doc[f"option{i}"] for i in range(1, 7)])
    return {"id": doc["id"], "predict_answer": predict,
            "response": response, "answer": doc.get("answer")}


def aggregate(records: List[dict]) -> Dict[str, float]:
    scored = [r for r in records if r.get("answer")]
    out = {"submission_rows": float(len(records))}
    if scored:
        out["ii_bench_accuracy"] = (
            sum(r["predict_answer"] == r["answer"] for r in scored)
            / len(scored))
    return out


def _load(data_root: str, split: str = "test") -> List[dict]:
    from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

    return load_benchmark_docs("lmms-lab/II-Bench", data_root, split)


register_task(Task(
    name="ii_bench",
    doc_to_visual=doc_to_visual,
    doc_to_text=doc_to_text,
    doc_to_target=lambda doc: doc.get("answer"),
    process_results=process_results,
    aggregate=aggregate,
    primary_metric="submission_rows",
    load_docs=_load,
    generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                       "do_sample": False},
))
